"""GKR-for-FFT-circuits subproof (Libra-style layered GKR).

Counterpart of ``virgo_plus_tpu/pc/fft_gkr.py`` (reference
lib/virgo/src/fft_circuit_GKR.cpp): a second GKR system that proves the VPD
verifier's q-polynomial FFT evaluation.  Circuit: beta-extension tensor
layers -> IFFT stages -> 1/n scale -> 64 evaluation points -> summation
(fft_circuit_GKR.cpp:22-101), built with the evaluation points' power
table by one ``fg_build_circuit`` launch up to lg = 12
(``csrc/fft_gkr.cu``; ``build_circuit``, plain twin
``build_circuit_plain``).  Every sumcheck is a fold, so on the card each
goes through K1: the prover's tape (``prove_messages``) folds all lg ifft
stages of a phase in one K1 call, and makes their tables in one
``fg_stage_tables`` launch (``stage_tables``, plain twin
``stage_tables_plain``); ``run`` goes stage by stage, as its verify mode
checks each stage in draw order.  The verifier's closed-form wiring
predicates are O(lg) host computations in exact ints.

Randomness is drawn from the shared transcript stream in the reference's
exact order (fft_gkr r's, eval points, r_0/r_1, per-layer r_u/r_v,
per-ifft-stage alpha/beta).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..field import chains, gf
from ..field import np_ops as fnp
from ..field.ref import Fq2
from ..gkr.beta import beta_table, beta_tables_batched
from ..gkr.sumcheck import (scan_sumcheck, scan_sumcheck_batched, mle_fold,
                            tree_sum)

MOD = gf.MOD


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return gf.to_numpy(x)
    return np.asarray(x, dtype=np.uint64)


def _t(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return gf.tensor(x, device)


def _fq2(el) -> Fq2:
    a = _np(el)
    return Fq2.raw(int(a[0]), int(a[1]))


def _draw_el(rng):
    r, i = rng.field_element()
    return np.array([r, i], dtype=np.uint64)


def _draw_vec(rng, n):
    """(2, n) challenges as host numpy."""
    vals = np.zeros((2, n), dtype=np.uint64)
    for k in range(n):
        vals[0, k], vals[1, k] = rng.field_element()
    return vals


@dataclass
class FFTGKRResult:
    ok: bool
    proof_size: int
    messages: list            # transcript items, in order (numpy uint64)


class _Tape:
    """Record (prove) or replay (standalone verify) the message stream."""

    def __init__(self, replay=None):
        self.replay = None if replay is None else list(replay)
        self.out = []
        self.pos = 0

    @property
    def recording(self):
        return self.replay is None

    def emit(self, compute):
        if self.replay is None:
            v = _np(compute())
            self.out.append(v)
            return v
        v = self.replay[self.pos]
        self.pos += 1
        return v

    def sumcheck(self, compute):
        """Record/replay a sumcheck's (polys, bound_v) message pair."""
        if self.replay is None:
            polys, (vb, _a, _m) = compute()
            self.out.append(_np(polys))
            self.out.append(_np(vb))
            return self.out[-2], self.out[-1]
        return self.emit(None), self.emit(None)


def _rot_mul(lg: int):
    rot = gf.inv_int(gf.root_of_unity_int(lg))
    out = []
    for _ in range(max(lg, 1)):
        out.append(rot)
        rot = gf._py_mul(rot, rot)
    return out


POINTS = 64             # evaluation points
# csrc/fft_gkr.cu: the largest lg fg_build_circuit builds in one launch,
# the words of a point an expansion block takes above it, the largest lg
ONE_LAUNCH_LOG = 12
CHUNK_LOG = 10
MAX_BUILD_LOG = 21


def circuit_launches(lg: int) -> int:
    """fg_build_circuit's launches for a 2^lg-point circuit: one up to
    ONE_LAUNCH_LOG; above it the tensor layers, one an ifft stage, the
    expansion and the sums."""
    return 1 if lg <= ONE_LAUNCH_LOG else lg + 3


def circuit_sizes(lg: int):
    """The words a plane of each layer build_circuit returns, in order:
    the tensor layers 2^0..2^lg, lg ifft layers and the scale layer of
    2^lg, the expansion and the sums."""
    n = 1 << lg
    return ([1 << k for k in range(lg + 1)] + [n] * (lg + 1)
            + [POINTS * n, POINTS])


def build_circuit(lg: int, r, eval_points):
    """fft_circuit_GKR.cpp:22-101.  r (2, lg), eval_points (2, 64) tensors.
    Returns (the list of layer value tensors (2, size) in build order, the
    points' power table (2, 64, 2^lg), which the mult layer reads too).
    The ifft stages' twiddles are ``stage_powers``' tables.  A CUDA tensor
    goes to ``fg_build_circuit`` (``circuit_launches(lg)`` launches), a
    CPU tensor to ``build_circuit_plain``."""
    fn = build_circuit_cuda if gf._on_cuda(r) else build_circuit_plain
    return fn(lg, r, eval_points)


def build_circuit_plain(lg: int, r, eval_points):
    """Plain twin of fg_build_circuit: the layer loops on gf's plain ops,
    the powers by doubling, the sums by the log tree."""
    kernels.PLAIN_CALLS["fg_build_circuit"] += 1
    add, sub, mul = gf.add_plain, gf.sub_plain, gf.mul_plain
    dev = r.device
    xp = stage_powers(lg, dev)
    one = gf.ones((1,), dev)
    layers = [one]
    for i in range(lg):
        prev = layers[-1]
        ri = r[:, i:i + 1]
        hi = mul(prev, ri)                       # index j<<1
        lo = mul(prev, sub(one, ri))             # index j<<1|1
        layers.append(torch.stack([hi, lo], dim=2).reshape(2, -1))
    # ifft stages (dep = lg-1 .. 0)
    n = 1 << lg
    for dep in range(lg - 1, -1, -1):
        m = 1 << dep
        half_blk = n >> (dep + 1)
        w = stage_twiddles(xp, lg, dep)
        pre = layers[-1].reshape(2, half_blk, 2, m)
        e = pre[:, :, 0, :]
        t = mul(w[:, :, None], pre[:, :, 1, :])
        layers.append(torch.cat([add(e, t), sub(e, t)], 1).reshape(2, n))
    # scale by inv_n (fastPow(n, mod-2), base field)
    inv_n = gf.pow_int((n % MOD, 0), MOD - 2)
    layers.append(mul(layers[-1], gf.full((1,), inv_n[0], inv_n[1], dev)))
    # 64 evaluation points: out[j + (i<<lg)] = scaled[j] * ep_i^j
    pw = gf.ones((POINTS, 1), dev)
    cur = eval_points
    while pw.shape[-1] < n:
        pw = torch.cat([pw, mul(pw, cur[..., None])], dim=-1)
        cur = mul(cur, cur)
    expansion = mul(layers[-1][:, None, :], pw)
    layers.append(expansion.reshape(2, POINTS * n))
    layers.append(chains.tree_sum_plain(expansion))     # (2, 64)
    return layers, pw


def build_circuit_cuda(lg: int, r, eval_points):
    """fg_build_circuit on the card: same arguments, results and bits as
    build_circuit_plain.  The layers and the power table are views of one
    buffer; r and eval_points are read in place (any strides)."""
    if not 0 <= lg <= MAX_BUILD_LOG:
        raise ValueError(f"fg_build_circuit: lg = {lg}, 0 to {MAX_BUILD_LOG} "
                         f"taken")
    dev = r.device
    if dev.type != "cuda" or eval_points.device != dev:
        raise ValueError("fg_build_circuit: r and eval_points must be on one "
                         "CUDA device")
    if r.dtype != torch.int64 or eval_points.dtype != torch.int64:
        raise TypeError("fg_build_circuit: expected int64 tensors")
    if tuple(r.shape) != (2, lg) or tuple(eval_points.shape) != (2, POINTS):
        raise ValueError(f"fg_build_circuit: r {tuple(r.shape)}, eval_points "
                         f"{tuple(eval_points.shape)}; (2, {lg}), (2, "
                         f"{POINTS}) taken")
    xp = stage_powers(lg, dev)
    n = 1 << lg
    buf = torch.empty(2 * (sum(circuit_sizes(lg)) + POINTS * n),
                      dtype=torch.int64, device=dev)
    parts = (torch.empty(2 * POINTS * (n >> CHUNK_LOG), dtype=torch.int64,
                         device=dev) if lg > ONE_LAUNCH_LOG else None)
    inv_n = gf.pow_int((n % MOD, 0), MOD - 2)
    kernels.launch("fg_build_circuit", circuit_launches(lg), r.data_ptr(),
                   r.stride(0), r.stride(1), eval_points.data_ptr(),
                   eval_points.stride(0), eval_points.stride(1),
                   xp.data_ptr(), inv_n[0], inv_n[1], buf.data_ptr(),
                   None if parts is None else parts.data_ptr(), lg,
                   kernels.stream_ptr())
    layers, off = [], 0
    for size in circuit_sizes(lg):
        layers.append(buf[2 * off:2 * (off + size)].view(2, size))
        off += size
    return layers, buf[2 * off:].view(2, POINTS, n)


def _two_point_beta(r0, r1, alpha, beta, bits: int):
    """alpha*eq(r0, .) + beta*eq(r1, .) over 2^bits."""
    return gf.add(beta_table(r0[:, :bits], bits, alpha),
                  beta_table(r1[:, :bits], bits, beta))


def draw_schedule(lg: int, rng) -> dict:
    """All transcript draws of one fft_gkr interaction, in the reference's
    exact stream order (message-independent)."""
    d = {
        "r": _draw_vec(rng, lg),
        "eval_points": _draw_vec(rng, 64),
        "r0": _draw_vec(rng, lg + 10),
        "r1": _draw_vec(rng, lg + 10),
        "add_ru": _draw_vec(rng, lg + 6),
        "add_rv": _draw_vec(rng, lg + 6),
        "mult_ru": _draw_vec(rng, lg),
        "mult_rv": _draw_vec(rng, lg),
    }
    stages = []
    for _ in range(lg):
        ru = _draw_vec(rng, lg)
        rv = _draw_vec(rng, lg)
        al = _draw_el(rng)
        be = _draw_el(rng)
        stages.append((ru, rv, al, be))
    d["stages"] = tuple(stages)
    return d


_POWERS = {}   # (lg, device) -> stage_powers' table


def stage_powers(lg: int, device):
    """The twiddles of every ifft stage of a 2^lg-point tape, (2, n - 1):
    stage dep's K = n >> (dep + 1) powers of rot_mul[dep] (1, x, x^2, ...)
    at n - (n >> dep).  Computed on the host in exact integers, made once
    per (lg, device) and kept: a CUDA graph replays it, and none is made
    inside a capture (the eager warm-up call before it makes it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (lg, dev)
    if key not in _POWERS:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"fft_gkr: no twiddle table for lg = {lg} on "
                               f"the capturing stream; an eager call makes "
                               f"it first")
        pows = []
        for dep, rot in enumerate(_rot_mul(lg)[:lg]):
            p = (1, 0)
            for _ in range((1 << lg) >> (dep + 1)):
                pows.append(p)
                p = gf._py_mul(p, rot)
        _POWERS[key] = gf.tensor(np.array(pows, dtype=np.uint64)
                                 .reshape(-1, 2).T, dev)
    return _POWERS[key]


def stage_twiddles(xp, lg: int, dep: int):
    """Stage dep's (2, n >> (dep + 1)) twiddles, a view of stage_powers'
    table xp."""
    n = 1 << lg
    off = n - (n >> dep)
    return xp[:, off:off + (n >> (dep + 1))]


def stage_tables(phase: int, bg, xp, src, vu, dep0: int):
    """The ifft stages' sumcheck tables (addV, am), each (2, S, n), for S
    stages dep0, dep0 + 1, ... of a 2^lg-point tape (n = 2^lg; xp =
    stage_powers(lg)).  Stage dep: m = 2^dep, K = n / 2m, slots e = 2km + t
    and o = e + m for k < K, t < m; bgA, bgB = bg (2, S, n) split at n/2.
    Phase 1 (src = V, the stages' pre-layers, vu None) writes addV[e] =
    ((bgA - bgB) x^k) V[o] and am[e] = bgA + bgB, zeros at o; phase 2
    (src = bu, the beta tables of ru; vu (2, S) the phase-1 bound v)
    am[o] = (bgA bu[e] - bgB bu[e]) x^k and addV[o] = (bgA bu[e] + bgB
    bu[e]) vu, zeros at e (prove_messages' formulas in the JAX package,
    in their order).  A CUDA tensor goes to ``fg_stage_tables`` (one
    launch), a CPU tensor to ``stage_tables_plain``."""
    fn = stage_tables_cuda if gf._on_cuda(bg) else stage_tables_plain
    return fn(phase, bg, xp, src, vu, dep0)


def stage_tables_plain(phase: int, bg, xp, src, vu, dep0: int):
    """Plain twin of fg_stage_tables: the per-stage formulas on gf's plain
    ops, vectorised over the stages by gathers of each stage's slots."""
    kernels.PLAIN_CALLS["fg_stage_tables"] += 1
    add, sub, mul = gf.add_plain, gf.sub_plain, gf.mul_plain
    S, n = bg.shape[1], bg.shape[2]
    half = n // 2
    j = torch.arange(half, device=bg.device)
    dep = torch.arange(dep0, dep0 + S, device=bg.device)[:, None]
    m = torch.ones_like(dep) << dep
    k = j >> dep                                        # (S, n/2)
    e = (k << (dep + 1)) + (j & (m - 1))
    o = e + m
    take = lambda t, idx: torch.gather(t, 2, idx.expand(2, S, half))
    bgA, bgB = bg[..., :half], bg[..., half:]
    xk = xp[:, n - (n >> dep) + k]                      # (2, S, n/2)
    if phase == 1:
        slot = e
        addV = mul(mul(sub(bgA, bgB), xk), take(src, o))
        am = add(bgA, bgB)
    else:
        slot = o
        bu = take(src, e)
        gA, gB = mul(bgA, bu), mul(bgB, bu)
        am = mul(sub(gA, gB), xk)
        addV = mul(add(gA, gB), vu[:, :, None])
    out = torch.zeros((2, 2, S, n), dtype=torch.int64, device=bg.device)
    for t, val in zip(out, (addV, am)):
        t.scatter_(2, slot.expand(2, S, half), val)
    return out[0], out[1]


def stage_tables_cuda(phase: int, bg, xp, src, vu, dep0: int):
    """fg_stage_tables on the card, one launch (none for no stage): same
    arguments, results and bits as stage_tables_plain."""
    if bg.dim() != 3 or phase not in (1, 2):
        raise ValueError(f"fg_stage_tables: phase {phase}, bg "
                         f"{tuple(bg.shape)}, (2, S, 2^lg) taken")
    S, n = bg.shape[1], bg.shape[2]
    lg = n.bit_length() - 1
    if n != 1 << lg or lg < 1:
        raise ValueError(f"fg_stage_tables: {n} points, 2^lg taken, lg >= 1")
    if not 0 <= dep0 <= lg - S:
        raise ValueError(f"fg_stage_tables: stages {dep0} + {S} of {lg}")
    ts = (bg, xp, src) + ((vu,) if phase == 2 else ())
    kernels.check_cuda("fg_stage_tables", ts,
                       [(2, S, n), (2, n - 1), (2, S, n), (2, S)])
    out = torch.empty((2, 2, S, n), dtype=torch.int64, device=bg.device)
    if S:
        kernels.launch("fg_stage_tables", 1, phase, bg.data_ptr(),
                       xp.data_ptr(), src.data_ptr(),
                       vu.data_ptr() if phase == 2 else None, out.data_ptr(),
                       S, lg, dep0, kernels.stream_ptr())
    return out[0], out[1]


def _stack(xs, device):
    """Draws (2, ...), host numpy or device tensors, stacked on axis 1: one
    host-to-device copy of numpy draws, else one stack on the device."""
    if all(isinstance(x, np.ndarray) for x in xs):
        return gf.tensor(np.stack(xs, axis=1), device)
    return torch.stack([_t(x, device) for x in xs], dim=1)


def prove_messages(lg: int, d: dict, device):
    """Prover side: the full fft_gkr message tape on the device, no host
    checks.  d: draw_schedule's dict (numpy, or device tensors inside a
    graph).  The tape layout matches run()'s record order exactly;
    run(replay=messages) verifies it.

    Phase 1 of ifft stage dep reads (r_0, r_1, alpha, beta) = (mult_ru,
    mult_rv, 1, 0) for dep 0 and stage dep - 1's (ru, rv, al, be) after,
    all in d, and phase 2 only its own phase-1 bound v_u.  So the stages
    run together: the two-point beta tables of all lg stages in two
    batched beta tables, the phase-1 tables in one ``stage_tables`` call,
    every stage's phase-1 sumcheck in one K1 call at (bl, K) = (lg, lg),
    then the bu tables, the phase-2 tables and a second K1 call."""
    T = lambda x: _t(x, device)
    layers, pw = build_circuit(lg, T(d["r"]), T(d["eval_points"]))
    r0, r1 = T(d["r0"]), T(d["r1"])
    msgs = [mle_fold(layers[-1], r0[:, :6])]
    n = 1 << lg
    one_el = gf.ones((), device)
    zero_el = gf.zeros((), device)

    # addition layer
    bg = _two_point_beta(r0, r1, one_el, zero_el, 6)
    V = layers[-2]
    am = bg[:, :, None].expand(2, 64, n).reshape(2, 64 * n)
    polys, (vb, _a, _m) = scan_sumcheck(V, torch.zeros_like(V), am,
                                        T(d["add_ru"]))
    msgs += [polys, vb]

    # mult layer
    bg_full = _two_point_beta(T(d["add_ru"]), T(d["add_rv"]), one_el,
                              zero_el, lg + 6)
    am = tree_sum(gf.mul(bg_full.reshape(2, 64, n), pw).transpose(1, 2))
    V = layers[2 * lg + 1]
    polys, (vb, _a, _m) = scan_sumcheck(V, torch.zeros_like(V), am,
                                        T(d["mult_ru"]))
    msgs += [polys, vb]
    if lg == 0:
        return msgs

    # ifft stages, all at once: stage dep's rows of the stacks
    st = d["stages"]
    host = isinstance(d["mult_ru"], np.ndarray)
    one, zero = ((np.array([1, 0], dtype=np.uint64),
                  np.zeros(2, dtype=np.uint64)) if host
                 else (one_el, zero_el))
    ru = _stack([s[0] for s in st], device)              # (2, lg, lg)
    rv = _stack([s[1] for s in st], device)
    prev = st[:-1]
    bg = gf.add(
        beta_tables_batched(_stack([d["mult_ru"]] + [s[0] for s in prev],
                                   device), lg,
                            _stack([one] + [s[2] for s in prev], device)),
        beta_tables_batched(_stack([d["mult_rv"]] + [s[1] for s in prev],
                                   device), lg,
                            _stack([zero] + [s[3] for s in prev], device)))
    xp = stage_powers(lg, device)
    V = torch.stack([layers[2 * lg - 1 - dep] for dep in range(lg)], dim=1)
    addV, am = stage_tables(1, bg, xp, V, None, 0)
    polys1, (v_u, _a, _m) = scan_sumcheck_batched(V, addV, am, ru)
    bu = beta_tables_batched(ru, lg, gf.ones((lg,), device))
    addV2, am2 = stage_tables(2, bg, xp, bu, v_u, 0)
    polys2, (v_v, _a, _m) = scan_sumcheck_batched(V, addV2, am2, rv)
    for dep in range(lg):
        msgs += [polys1[:, dep], v_u[:, dep], polys2[:, dep], v_v[:, dep]]
    return msgs


def fft_gkr_proof_size(lg: int) -> int:
    """Static proof-size accounting matching run()'s counters."""
    ps = 48 * (lg + 6)          # addition layer
    ps += 48 * lg               # mult layer
    ps += 2 * 48 * lg * lg      # ifft stages (p1 + p2 per stage)
    for i in range(1, lg + 1):  # extension part (size only)
        ps += 48 * i
    return ps


def run(lg: int, rng, replay=None, *, device) -> FFTGKRResult:
    """The whole fft_gkr interaction.  Prove mode (replay=None): device
    sumchecks record the message transcript.  Verify mode: messages are
    replayed and only the checks run (no circuit evaluation; the beta
    tables still build on ``device``).
    rng: the shared transcript stream (same draws in both modes)."""
    ok = True
    proof_size = 0
    tape = _Tape(replay)
    T = lambda x: _t(x, device)

    r = _draw_vec(rng, lg)
    eval_points = _draw_vec(rng, 64)
    layers, pw = (build_circuit(lg, T(r), T(eval_points)) if tape.recording
                  else (None, None))

    r_0 = _draw_vec(rng, lg + 10)
    r_1 = _draw_vec(rng, lg + 10)

    # the running claim ab_sum and alpha/beta stay host numpy
    alpha = np.array([1, 0], dtype=np.uint64)
    beta = np.array([0, 0], dtype=np.uint64)

    # a_0 = V_output: fold the 64 sums at r_0[:6]
    if tape.recording:
        ab_sum = tape.emit(lambda: mle_fold(layers[-1], T(r_0)[:, :6]))
    else:
        ab_sum = tape.emit(None)

    n = 1 << lg

    # ---------------- addition layer (fft_circuit_GKR.cpp:227-332) --------
    log_uv = lg + 6
    bg = _two_point_beta(T(r_0), T(r_1), T(alpha), T(beta), 6)   # (2, 64)
    r_u = _draw_vec(rng, log_uv)
    r_v = _draw_vec(rng, log_uv)

    def _add_layer():
        V = layers[-2]                                   # (2, 64*n) expansion
        am = bg[:, :, None].expand(2, 64, n).reshape(2, 64 * n)
        return scan_sumcheck(V, torch.zeros_like(V), am, T(r_u))

    polys, v_u = tape.sumcheck(_add_layer)
    proof_size += 48 * log_uv
    ok_c, ab = _chain_host(polys, r_u, _fq2(ab_sum))
    ok &= ok_c
    # verifier: summation_val = sum_i bg(i) * eq(r_u[high 6], bits(i))
    bg_np = _np(bg)
    bg_host = [_fq2(bg_np[:, i]) for i in range(64)]
    ru_host = [_fq2(r_u[:, j]) for j in range(log_uv)]
    s_val = Fq2.raw(0, 0)
    for i in range(64):
        tmp = bg_host[i]
        for j in range(6):
            bit = (i >> j) & 1
            rr = ru_host[log_uv - 6 + j]
            tmp = tmp * (rr if bit else (Fq2.raw(1, 0) - rr))
        s_val = s_val + tmp
    if ab != s_val * _fq2(v_u):
        ok = False
    ab_sum = fnp.mul(alpha, _np(v_u))
    r_0, r_1 = r_u, r_v

    # ---------------- mult layer (fft_circuit_GKR.cpp:334-447) ------------
    length_g = lg + 6
    r_u = _draw_vec(rng, lg)
    r_v = _draw_vec(rng, lg)

    def _mult_layer():
        bg_full = _two_point_beta(T(r_0), T(r_1), T(alpha), T(beta), length_g)
        am = tree_sum(gf.mul(bg_full.reshape(2, 64, n), pw)
                           .transpose(1, 2))
        V = layers[2 * lg + 1]                            # scale layer (2, n)
        return scan_sumcheck(V, torch.zeros_like(V), am, T(r_u))

    polys, v_u = tape.sumcheck(_mult_layer)
    proof_size += 48 * lg
    ok_c, ab = _chain_host(polys, r_u, _fq2(ab_sum))
    ok &= ok_c
    # verifier closed form (fft_circuit_GKR.cpp:408-432)
    al_h, be_h = _fq2(alpha), _fq2(beta)
    r0_h = [_fq2(r_0[:, j]) for j in range(length_g)]
    r1_h = [_fq2(r_1[:, j]) for j in range(length_g)]
    ru_h = [_fq2(r_u[:, j]) for j in range(lg)]
    summation_mult = Fq2.raw(0, 0)
    ep_h = [_fq2(eval_points[:, i]) for i in range(64)]
    for i in range(64):
        g0, g1 = al_h, be_h
        for j in range(6):
            bit = (i >> j) & 1
            if bit:
                g0 = g0 * r0_h[length_g - 6 + j]
                g1 = g1 * r1_h[length_g - 6 + j]
            else:
                g0 = g0 * (one - r0_h[length_g - 6 + j])
                g1 = g1 * (one - r1_h[length_g - 6 + j])
        u0, u1 = one, one
        x = ep_h[i]
        for j in range(lg):
            u0 = u0 * (r0_h[j] * ru_h[j] * x + (one - r0_h[j]) * (one - ru_h[j]))
            u1 = u1 * (r1_h[j] * ru_h[j] * x + (one - r1_h[j]) * (one - ru_h[j]))
            x = x * x
        summation_mult = summation_mult + g0 * u0 + g1 * u1
    if ab != summation_mult * _fq2(v_u):
        ok = False
    ab_sum = fnp.mul(alpha, _np(v_u))
    r_0, r_1 = r_u, r_v

    # ---------------- intermediate (scale) layer --------------------------
    ab_sum = fnp.mul(ab_sum, np.array([n % MOD, 0], dtype=np.uint64))

    # ---------------- ifft stages (fft_circuit_GKR.cpp:458-769) -----------
    rot_mul = _rot_mul(lg)
    xp = stage_powers(lg, device) if tape.recording else None

    for dep in range(lg):
        pre_layer = layers[lg + (lg - dep) - 1] if tape.recording else None
        r_u = _draw_vec(rng, lg)
        r_v = _draw_vec(rng, lg)

        # device-only quantities build INSIDE the recording closures so the
        # replay path touches no device at all
        def _bg():
            return _two_point_beta(T(r_0), T(r_1), T(alpha), T(beta),
                                   lg)[:, None]

        def _stage_p1():
            addV, am = stage_tables(1, _bg(), xp, pre_layer[:, None], None,
                                    dep)
            return scan_sumcheck(pre_layer, addV[:, 0], am[:, 0], T(r_u))

        polys, v_u = tape.sumcheck(_stage_p1)
        proof_size += 48 * lg
        ok_c, ab1 = _chain_host(polys, r_u, _fq2(ab_sum))
        ok &= ok_c

        def _stage_p2():
            bu = beta_table(T(r_u)[:, :lg], lg, gf.ones((), device))
            addV2, am2 = stage_tables(2, _bg(), xp, bu[:, None],
                                      T(v_u)[:, None], dep)
            return scan_sumcheck(pre_layer, addV2[:, 0], am2[:, 0], T(r_v))

        polys2, v_v = tape.sumcheck(_stage_p2)
        proof_size += 48 * lg
        ok_c, ab2 = _chain_host(polys2, r_v, ab1)
        ok &= ok_c
        # verifier closed form (fft_circuit_GKR.cpp:647-751)
        x_h = Fq2.raw(*rot_mul[dep])
        log_k = lg - dep - 1   # mylog(blk_size/2) = lg - dep - 1
        log_j = dep
        r0_h = [_fq2(r_0[:, j]) for j in range(lg)]
        r1_h = [_fq2(r_1[:, j]) for j in range(lg)]
        ru_h = [_fq2(r_u[:, j]) for j in range(lg)]
        rv_h = [_fq2(r_v[:, j]) for j in range(lg)]
        al_h, be_h = _fq2(alpha), _fq2(beta)
        base_u_0 = (one - r0_h[lg - 1]) * (one - ru_h[log_j]) * rv_h[log_j] * al_h
        base_u_1 = (one - r1_h[lg - 1]) * (one - ru_h[log_j]) * rv_h[log_j] * be_h
        sv0A = base_u_0
        sv1A = base_u_1
        su0A, su1A = base_u_0, base_u_1
        su0B = r0_h[lg - 1] * (one - ru_h[log_j]) * rv_h[log_j] * al_h
        su1B = r1_h[lg - 1] * (one - ru_h[log_j]) * rv_h[log_j] * be_h
        sv0B, sv1B = su0B, su1B
        x = x_h
        for i in range(log_k):
            eu = lambda rr: (rr[log_j + i] * ru_h[log_j + 1 + i] * rv_h[log_j + 1 + i]
                             + (one - rr[log_j + i]) * (one - ru_h[log_j + 1 + i])
                             * (one - rv_h[log_j + 1 + i]))
            evx = lambda rr: (rr[log_j + i] * ru_h[log_j + 1 + i]
                              * rv_h[log_j + 1 + i] * x
                              + (one - rr[log_j + i]) * (one - ru_h[log_j + 1 + i])
                              * (one - rv_h[log_j + 1 + i]))
            su0A = su0A * eu(r0_h)
            su1A = su1A * eu(r1_h)
            sv0A = sv0A * evx(r0_h)
            sv1A = sv1A * evx(r1_h)
            su0B = su0B * eu(r0_h)
            su1B = su1B * eu(r1_h)
            sv0B = sv0B * evx(r0_h)
            sv1B = sv1B * evx(r1_h)
            x = x * x
        for i in range(log_j):
            eu2 = lambda rr: (rr[i] * ru_h[i] * rv_h[i]
                              + (one - rr[i]) * (one - ru_h[i]) * (one - rv_h[i]))
            su0A = su0A * eu2(r0_h)
            su1A = su1A * eu2(r1_h)
            sv0A = sv0A * eu2(r0_h)
            sv1A = sv1A * eu2(r1_h)
            su0B = su0B * eu2(r0_h)
            su1B = su1B * eu2(r1_h)
            sv0B = sv0B * eu2(r0_h)
            sv1B = sv1B * eu2(r1_h)
        vu_h2, vv_h2 = _fq2(v_u), _fq2(v_v)
        expect = (su0A + su1A + su0B + su1B) * vu_h2 + \
                 (sv0A + sv1A - sv0B - sv1B) * vv_h2
        if ab2 != expect:
            ok = False
        # new alpha/beta
        alpha = _draw_el(rng)
        beta = _draw_el(rng)
        ab_sum = fnp.add(fnp.mul(alpha, _np(v_u)), fnp.mul(beta, _np(v_v)))
        r_0, r_1 = r_u, r_v

    # extension part: proof size only (fft_circuit_GKR.cpp:771-780)
    for i in range(1, lg + 1):
        proof_size += 48 * i

    return FFTGKRResult(ok=bool(ok), proof_size=proof_size,
                        messages=tape.out)


one = Fq2.raw(1, 0)


def _chain_host(polys, rs, prev: Fq2):
    """Host check of a sumcheck round chain: every p_j(0) + p_j(1) equals
    the running claim, which then becomes p_j(r_j).  Returns (ok, claim)."""
    p = _np(polys)
    rs_np = _np(rs)
    cur = prev
    ok = True
    for j in range(p.shape[0]):
        a = Fq2.raw(int(p[j, 0, 0]), int(p[j, 1, 0]))
        b = Fq2.raw(int(p[j, 0, 1]), int(p[j, 1, 1]))
        c = Fq2.raw(int(p[j, 0, 2]), int(p[j, 1, 2]))
        if a + b + c + c != cur:
            ok = False
        r = Fq2.raw(int(rs_np[0, j]), int(rs_np[1, j]))
        cur = (a * r + b) * r + c
    return ok, cur
