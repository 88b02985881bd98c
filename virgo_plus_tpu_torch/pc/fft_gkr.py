"""GKR-for-FFT-circuits subproof (Libra-style layered GKR).

Counterpart of ``virgo_plus_tpu/pc/fft_gkr.py`` (reference
lib/virgo/src/fft_circuit_GKR.cpp): a second GKR system that proves the VPD
verifier's q-polynomial FFT evaluation.  Circuit: beta-extension tensor
layers -> IFFT stages -> 1/n scale -> 64 evaluation points -> summation
(fft_circuit_GKR.cpp:22-101).  Every sumcheck is one single-table fold
(``scan_sumcheck``), so on the card each goes through K1.  The verifier's
closed-form wiring predicates are O(lg) host computations in exact ints.

Randomness is drawn from the shared transcript stream in the reference's
exact order (fft_gkr r's, eval points, r_0/r_1, per-layer r_u/r_v,
per-ifft-stage alpha/beta).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import chains, gf
from ..field import np_ops as fnp
from ..field.ref import Fq2
from ..gkr.beta import beta_table
from ..gkr.sumcheck import scan_sumcheck, mle_fold, tree_sum
from .fft import powers

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


def powers_el(base, n: int):
    """(2, K) elements -> (2, K, n) powers, one ``chains.table`` call."""
    return chains.table(chains.POWER, base, None, n, base.device)


def _rot_mul(lg: int):
    rot = gf.inv_int(gf.root_of_unity_int(lg))
    out = []
    for _ in range(max(lg, 1)):
        out.append(rot)
        rot = gf._py_mul(rot, rot)
    return out


def build_circuit(lg: int, r, eval_points):
    """fft_circuit_GKR.cpp:22-101.  r (2, lg), eval_points (2, 64) tensors.
    Returns the list of layer value tensors (2, size) in build order."""
    dev = r.device
    one = gf.ones((1,), dev)
    layers = [one]
    for i in range(lg):
        prev = layers[-1]
        ri = r[:, i:i + 1]
        hi = gf.mul(prev, ri)                    # index j<<1
        lo = gf.mul(prev, gf.sub(one, ri))       # index j<<1|1
        layers.append(torch.stack([hi, lo], dim=2).reshape(2, -1))
    # ifft stages (dep = lg-1 .. 0)
    rot_mul = _rot_mul(lg)
    n = 1 << lg
    for dep in range(lg - 1, -1, -1):
        m = 1 << dep
        half_blk = n >> (dep + 1)
        w = powers(rot_mul[dep], half_blk, dev)
        pre = layers[-1].reshape(2, half_blk, 2, m)
        e = pre[:, :, 0, :]
        t = gf.mul(w[:, :, None], pre[:, :, 1, :])
        layers.append(torch.cat([gf.add(e, t), gf.sub(e, t)], 1).reshape(2, n))
    # scale by inv_n (fastPow(n, mod-2), base field)
    inv_n = gf.pow_int((n % MOD, 0), MOD - 2)
    layers.append(gf.mul(layers[-1], gf.full((1,), inv_n[0], inv_n[1], dev)))
    # 64 evaluation points: out[j + (i<<lg)] = scaled[j] * ep_i^j
    expansion = gf.mul(layers[-1][:, None, :], powers_el(eval_points, n))
    layers.append(expansion.reshape(2, 64 * n))
    layers.append(tree_sum(expansion))              # (2, 64)
    return layers


def _two_point_beta(r0, r1, alpha, beta, bits: int):
    """alpha*eq(r0, .) + beta*eq(r1, .) over 2^bits."""
    return gf.add(beta_table(r0[:, :bits], bits, alpha),
                  beta_table(r1[:, :bits], bits, beta))


def _interleave(even, odd, n: int):
    """(2, K, m) even/odd halves -> (2, n) with [k, 0|1, j] order."""
    return torch.stack([even, odd], dim=2).reshape(2, n)


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


def _stage_tables(pre_layer, bgA, bgB, x_pows, n):
    """Phase-1 tables of one ifft stage (scatter onto even positions)."""
    K, m = bgA.shape[1], bgA.shape[2]
    v_odd = pre_layer.reshape(2, K, 2, m)[:, :, 1, :]
    am_e = gf.add(bgA, bgB)
    addV_e = gf.mul(gf.mul(gf.sub(bgA, bgB), x_pows[:, :, None]), v_odd)
    zero = torch.zeros_like(am_e)
    return _interleave(addV_e, zero, n), _interleave(am_e, zero, n)


def _stage_tables_p2(bgA, bgB, x_pows, bu_full, v_u, n):
    """Phase-2 tables of one ifft stage (scatter onto odd positions)."""
    K, m = bgA.shape[1], bgA.shape[2]
    bu_u = bu_full.reshape(2, K, 2, m)[:, :, 0, :]
    gA_u = gf.mul(bgA, bu_u)
    gB_u = gf.mul(bgB, bu_u)
    am_o = gf.mul(gf.sub(gA_u, gB_u), x_pows[:, :, None])
    addV_o = gf.mul(gf.add(gA_u, gB_u), v_u[:, None, None])
    zero = torch.zeros_like(am_o)
    return _interleave(zero, addV_o, n), _interleave(zero, am_o, n)


def prove_messages(lg: int, d: dict, device):
    """Prover side: the full fft_gkr message tape on the device, no host
    checks.  d: draw_schedule's dict.  The tape layout matches run()'s
    record order exactly; run(replay=messages) verifies it."""
    T = lambda x: _t(x, device)
    layers = build_circuit(lg, T(d["r"]), T(d["eval_points"]))
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
    pw = powers_el(T(d["eval_points"]), n)
    am = tree_sum(gf.mul(bg_full.reshape(2, 64, n), pw).transpose(1, 2))
    V = layers[2 * lg + 1]
    polys, (vb, _a, _m) = scan_sumcheck(V, torch.zeros_like(V), am,
                                        T(d["mult_ru"]))
    msgs += [polys, vb]

    # ifft stages
    rot_mul = _rot_mul(lg)
    r_0, r_1 = T(d["mult_ru"]), T(d["mult_rv"])
    alpha, beta = one_el, zero_el
    for dep in range(lg):
        ru, rv, al_next, be_next = (T(x) for x in d["stages"][dep])
        m = 1 << dep
        K = n >> (dep + 1)
        pre_layer = layers[lg + (lg - dep) - 1]
        x_pows = powers(rot_mul[dep], K, device)
        resh = _two_point_beta(r_0, r_1, alpha, beta, lg).reshape(2, 2, K, m)
        bgA, bgB = resh[:, 0], resh[:, 1]
        addV, am = _stage_tables(pre_layer, bgA, bgB, x_pows, n)
        polys, (v_u, _a, _m2) = scan_sumcheck(pre_layer, addV, am, ru)
        msgs += [polys, v_u]

        bu_full = beta_table(ru[:, :lg], lg, one_el)
        addV2, am2 = _stage_tables_p2(bgA, bgB, x_pows, bu_full, v_u, n)
        polys2, (v_v, _a, _m2) = scan_sumcheck(pre_layer, addV2, am2, rv)
        msgs += [polys2, v_v]

        alpha, beta = al_next, be_next
        r_0, r_1 = ru, rv
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
    layers = build_circuit(lg, T(r), T(eval_points)) if tape.recording \
        else None

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
        pw = powers_el(T(eval_points), n)
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

    for dep in range(lg):
        m = 1 << dep
        K = n >> (dep + 1)      # blk_size/2
        pre_layer = layers[lg + (lg - dep) - 1] if tape.recording else None
        r_u = _draw_vec(rng, lg)
        r_v = _draw_vec(rng, lg)

        # device-only quantities build INSIDE the recording closures so the
        # replay path touches no device at all
        def _bg_parts():
            x_pows = powers(rot_mul[dep], K, device)
            resh = _two_point_beta(T(r_0), T(r_1), T(alpha), T(beta),
                                   lg).reshape(2, 2, K, m)
            return resh[:, 0], resh[:, 1], x_pows

        def _stage_p1():
            bgA, bgB, x_pows = _bg_parts()
            addV, am = _stage_tables(pre_layer, bgA, bgB, x_pows, n)
            return scan_sumcheck(pre_layer, addV, am, T(r_u))

        polys, v_u = tape.sumcheck(_stage_p1)
        proof_size += 48 * lg
        ok_c, ab1 = _chain_host(polys, r_u, _fq2(ab_sum))
        ok &= ok_c

        def _stage_p2():
            bgA, bgB, x_pows = _bg_parts()
            bu_full = beta_table(T(r_u)[:, :lg], lg, gf.ones((), device))
            addV2, am2 = _stage_tables_p2(bgA, bgB, x_pows, bu_full,
                                          T(v_u), n)
            return scan_sumcheck(pre_layer, addV2, am2, T(r_v))

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
