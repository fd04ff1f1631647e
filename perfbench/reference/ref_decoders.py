"""The plain reference: the benchmark's own decoders and classification.

Plain PyTorch, written for this benchmark and sharing no code with the
program.  It follows the published algorithms as the reference decoder
(cantwellc/QEC_LDPC) defines them, in the floating-point association order
that the configuration states, so that in float32 it gives the program's
answers bit for bit:

  * sum-product in the probability domain: check rule
    ``E = 0.5 - (0.5 - s) * prod_{l' != l} (1 - 2 V)``, variable rule
    ``p prod E / ((1 - p) prod (1 - E) + p prod E)`` with the denominator
    formed as one fused multiply-add, leaving out the target check except on
    the last iteration; leave-one-out products as exclusive prefix and
    suffix products, in position (check side) and rank (variable side)
    order;
  * normalized min-sum on LLRs (alpha = 0.75): check rule
    ``E = s_sign * alpha * prod sign * min |V|`` over the others, variable
    rule ``prior + sum`` of the others as prefix plus suffix sums; the
    damped form (relay) blends ``fma(1 - d, V_new, d * V_old)``;
  * a convergence test after iterations 1, 1 + k, 1 + 2k, ... (k the
    check cadence); a converged lane is frozen and counts no further
    iteration;
  * relay: up to R retries of damped min-sum on the lanes whose decision
    violates the syndrome, each retry of a chunk on all its lanes (solved
    ones with a zero syndrome) while one of them is unsolved;
  * OSD-0: rank the variables by soft output (smallest first, stable), take
    the first linearly independent columns of H in that order and solve
    ``H_S e_S = s`` over GF(2);
  * the rank-basis classification into nine counters.

``dtype`` selects the arithmetic: float32 is the configuration's precision;
bfloat16 is the control that the comparison must reject.  ``exact=False``
(the witness) keeps float32 but leaves the kernels' association order:
each leave-one-out product or sum is PyTorch's reduction over the others,
a total its reduction over all, and the multiply-add rounds twice.  It
reads what a float32 decoder that orders its arithmetic otherwise gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ref_codes import gf2_rref
from ref_sampling import errors, gammas

SYN_X, SYN_Z, CONV_X, CONV_Z = 1, 2, 4, 8


def f32(x: float) -> float:
    return float(np.float32(x))


class Graph:
    """A :class:`codes.Tanner` graph's index tensors on a device."""

    def __init__(self, tanner, device):
        self.t = tanner
        self.m, self.n = tanner.num_checks, tanner.num_vars
        self.dc, self.dv = tanner.check_degree, tanner.var_degree
        self.var_of = torch.as_tensor(tanner.var_of, device=device)
        edge_of = tanner.edge_of.reshape(-1)
        to_check = np.empty_like(edge_of)
        to_check[edge_of] = np.arange(edge_of.size)
        self.to_var_idx = torch.as_tensor(edge_of, device=device)
        self.to_check_idx = torch.as_tensor(to_check, device=device)
        self.var_of_flat = self.var_of.reshape(-1)

    def to_var(self, x):
        """(dc*m, B) check view -> (dv, n, B) variable view."""
        return x.index_select(0, self.to_var_idx).view(self.dv, self.n, -1)

    def to_check(self, x):
        """(dv, n, B) variable view -> (dc*m, B) check view."""
        return x.reshape(self.dv * self.n, -1).index_select(0, self.to_check_idx)

    def syndrome(self, bits):
        """(n, B) 0/1 -> (m, B) uint8."""
        per_edge = bits.to(torch.int32).index_select(0, self.var_of_flat)
        return (per_edge.view(self.dc, self.m, -1).sum(0) % 2).to(torch.uint8)


def fma(a, b, c):
    """``a * b + c`` rounded once (float32 inputs): the float64 product is
    exact; the float64 sum is made round-to-odd before the final rounding."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return s.float()


def mul_add(a, b, c, exact=True):
    """The configuration's fused multiply-add in float32; plain in a lower
    precision (the control) or out of the kernels' order (the witness)."""
    if exact and c.dtype == torch.float32:
        return fma(a, b, c)
    return a * b + c


def scans(terms, combine, identity):
    """Exclusive prefix and suffix scans in list order."""
    k = len(terms)
    pre, suf = [identity] * k, [identity] * k
    for i in range(1, k):
        pre[i] = combine(pre[i - 1], terms[i - 1])
    for i in range(k - 2, -1, -1):
        suf[i] = combine(suf[i + 1], terms[i + 1])
    return pre, suf


def others(terms, i):
    return torch.stack(terms[:i] + terms[i + 1:])


def loo_products(terms, exact=True):
    if not exact:
        return [others(terms, i).prod(0) for i in range(len(terms))]
    pre, suf = scans(terms, torch.mul, torch.ones_like(terms[0]))
    return [p * s for p, s in zip(pre, suf)]


def loo_sums(terms, exact=True):
    if not exact:
        return [others(terms, i).sum(0) for i in range(len(terms))]
    pre, suf = scans(terms, torch.add, torch.zeros_like(terms[0]))
    return [p + s for p, s in zip(pre, suf)]


def loo_min(mags):
    """(d, m, B) magnitudes -> the minimum over the other positions, NaN
    where another position is NaN (min and NaN are exact, so any order
    gives the same)."""
    nan = mags.isnan()
    clean = torch.where(nan, math.inf, mags)
    two, idx = torch.topk(clean, 2, dim=0, largest=False)
    pos = torch.arange(mags.shape[0], device=mags.device).view(-1, 1, 1)
    out = torch.where(pos == idx[0:1], two[1:2], two[0:1])
    others_nan = (nan.sum(0, keepdim=True) - nan.to(torch.int64)) > 0
    return torch.where(others_nan, math.nan, out)


def sum_product(g: Graph, syn, prior: np.float32, cfg: dict, dtype,
                exact=True):
    """Returns (final check-view messages, per-lane iterations)."""
    B = syn.shape[1]
    dev = syn.device
    half = (0.5 - syn.to(dtype)).unsqueeze(0)               # (1, m, B)
    p = torch.tensor(float(prior), dtype=dtype, device=dev)
    v = p.expand(g.dc * g.m, B).clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    low, high = f32(cfg["conv_low"]), f32(cfg["conv_high"])
    cap, every = cfg["max_iters"], cfg["check_every"]
    for it in range(cap):
        t = (1.0 - 2.0 * v).view(g.dc, g.m, B)
        e = 0.5 - half * torch.stack(
            loo_products([t[j] for j in range(g.dc)], exact))
        ev = g.to_var(e.reshape(g.dc * g.m, B))
        tp = [ev[i] for i in range(g.dv)]
        tm = [1.0 - ev[i] for i in range(g.dv)]
        if it == cap - 1 and exact:
            lp, lm = loo_products(tp), loo_products(tm)
            prod_p = (lp[-1] * tp[-1]).expand(g.dv, g.n, B)
            prod_m = (lm[-1] * tm[-1]).expand(g.dv, g.n, B)
        elif it == cap - 1:
            prod_p = torch.stack(tp).prod(0).expand(g.dv, g.n, B)
            prod_m = torch.stack(tm).prod(0).expand(g.dv, g.n, B)
        else:
            prod_p = torch.stack(loo_products(tp, exact))
            prod_m = torch.stack(loo_products(tm, exact))
        num = p * prod_p
        vv = num / mul_add(1.0 - p, prod_m, num, exact)
        v = torch.where(done, v, g.to_check(vv))
        iters += ~done
        if it % every == 0:
            inside = ((v != 0.0) & (v > low) & (v < high)).any(0)
            done = done | ~inside
            if bool(done.all()):
                break
    return v, iters


def min_sum(g: Graph, syn, llr: float, cfg: dict, dtype, damping=None,
            exact=True):
    """Returns (final check-view LLRs, per-lane iterations).  ``damping``:
    per-edge (check view) blend coefficients."""
    B = syn.shape[1]
    dev = syn.device
    sign = (1.0 - 2.0 * syn.to(dtype)).unsqueeze(0)          # (1, m, B)
    v = torch.full((g.dc * g.m, B), llr, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    alpha = f32(cfg["alpha"])
    band = f32(math.log((1.0 - cfg["conv_low"]) / cfg["conv_low"]))
    cap, every = cfg["max_iters"], cfg["check_every"]
    for it in range(cap):
        t = v.view(g.dc, g.m, B)
        sg = torch.where(t < 0, -1.0, 1.0).to(dtype)
        loo_sign = sg.prod(0, keepdim=True) * sg              # exact: +-1
        e = sign * ((alpha * loo_sign) * loo_min(t.abs()))
        ev = g.to_var(e.reshape(g.dc * g.m, B))
        terms = [ev[i] for i in range(g.dv)]
        if it == cap - 1 and exact:
            sums = (loo_sums(terms)[-1] + terms[-1]).expand(g.dv, g.n, B)
        elif it == cap - 1:
            sums = torch.stack(terms).sum(0).expand(g.dv, g.n, B)
        else:
            sums = torch.stack(loo_sums(terms, exact))
        v_new = g.to_check(llr + sums)
        if damping is not None:
            v_new = mul_add(1.0 - damping, v_new, damping * v, exact)
        v = torch.where(done, v, v_new)
        iters += ~done
        if it % every == 0:
            done = done | ~(v.abs() < band).any(0)
            if bool(done.all()):
                break
    return v, iters


def prior_of(traffic: dict) -> np.float32:
    return np.float32(2.0 / 3.0) * np.float32(traffic["p"])


def prior_llr(prior: np.float32) -> float:
    """log1p(-p) - log(p) in float32 on the host."""
    p = torch.tensor(prior, dtype=torch.float32)
    return float(torch.log1p(-p) - torch.log(p))


def decode(g: Graph, syn, traffic: dict, dtype, soft=False, exact=True):
    """One graph: (decisions uint8, convergence fail, syndrome fail,
    per-lane iterations, soft outputs or None)."""
    cfg = traffic["decoder"]
    if cfg["algorithm"] == "sum-product":
        v, iters = sum_product(g, syn, prior_of(traffic), cfg, dtype, exact)
        vv = g.to_var(v)
        dec = (vv >= 0.5).any(0)
        low, high = f32(cfg["conv_low"]), f32(cfg["conv_high"])
        conv = ((v != 0.0) & (v > low) & (v < high)).any(0)
        out_soft = None
    elif cfg["algorithm"] == "min-sum":
        v, iters = min_sum(g, syn, prior_llr(prior_of(traffic)), cfg, dtype,
                           exact=exact)
        vv = g.to_var(v)
        dec = (vv <= 0.0).any(0)
        band = f32(math.log((1.0 - cfg["conv_low"]) / cfg["conv_low"]))
        conv = (v.abs() < band).any(0)
        out_soft = None
        if soft and not exact:
            out_soft = vv.sum(0)
        elif soft:
            out_soft = vv[0]
            for i in range(1, g.dv):
                out_soft = out_soft + vv[i]
    else:
        raise ValueError(f"unknown algorithm {cfg['algorithm']!r}")
    dec = dec.to(torch.uint8)
    synf = (g.syndrome(dec) != syn).any(0)
    return dec, conv, synf, iters, out_soft


def osd0(h, rank: int, syn, soft, block: int = 1024):
    """OSD-0 of K lanes: h (m, n) uint8 of GF(2) rank ``rank`` on the
    device, syn (m, K), soft (n, K).  Returns ((n, K) uint8 corrections,
    (K,) bool solved), ``block`` lanes at a time."""
    m, n = h.shape
    K = syn.shape[1]
    dev = h.device
    if K > block:
        parts = [osd0(h, rank, syn[:, i:i + block], soft[:, i:i + block],
                      block) for i in range(0, K, block)]
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts]))
    if K == 0:
        return (torch.zeros((n, 0), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    key = soft.T.float().cpu().numpy()
    order = torch.as_tensor(np.argsort(key, axis=1, kind="stable"), device=dev)
    words = -(-n // 64)
    a = h[:, order].permute(1, 0, 2).to(torch.int64)        # (K, m, n)
    a = torch.nn.functional.pad(a, (0, 64 * words - n)).view(K, m, words, 64)
    a = (a << torch.arange(64, device=dev)).sum(-1)          # (K, m, words)
    s = syn.T.to(torch.bool).clone()                         # (K, m)
    used = torch.zeros((K, m), dtype=torch.bool, device=dev)
    pivcol = torch.full((K, m), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(K, device=dev)
    for j in range(n):
        bit = ((a[:, :, j >> 6] >> (j & 63)) & 1).to(torch.bool)
        cand = bit & ~used
        has = cand.any(1)
        r = cand.to(torch.float32).argmax(1)
        prow = a[lanes, r]                                   # (K, words)
        ps = s[lanes, r]
        mask = bit & has[:, None]
        mask[lanes, r] = False
        a = a ^ torch.where(mask[..., None], prow[:, None, :], 0)
        s = s ^ (mask & ps[:, None])
        pivcol[lanes, r] = torch.where(has, j, pivcol[lanes, r])
        used[lanes, r] |= has
        if j % 32 == 31 and bool((used.sum(1) >= rank).all()):
            break
    solved = ~(s & ~used).any(1)
    e_perm = torch.zeros((K, n + 1), dtype=torch.uint8, device=dev)
    e_perm.scatter_(1, torch.where(used, pivcol, n), (s & used).to(torch.uint8))
    e = torch.zeros((K, n), dtype=torch.uint8, device=dev)
    e.scatter_(1, order, e_perm[:, :n])
    return e.T.contiguous(), solved


class Basis:
    """Rank-basis membership in the rowspace of one matrix, on a device."""

    def __init__(self, mat, device):
        g, piv = gf2_rref(mat)
        self.gt = torch.as_tensor(g.T.astype(np.float64), device=device)
        self.piv = torch.as_tensor(piv, device=device)

    def outside(self, r):
        """(n, B) 0/1 residual -> (B,) bool: not in the rowspace."""
        coeff = r.index_select(0, self.piv).double()
        recon = self.gt @ coeff
        return (torch.remainder(recon + r.double(), 2.0) > 0.5).any(0)


def classify(basis_x: Basis, basis_z: Basis, x, z, dx, dz, ec):
    """(9,) int64 counters of the lanes: tested, x tested, z tested,
    corrected, syndrome-fail x, syndrome-fail z, logical, convergence-fail
    x, convergence-fail z."""
    syn_x, syn_z = (ec & SYN_X) != 0, (ec & SYN_Z) != 0
    undetected = ~(syn_x | syn_z)
    logical = (basis_x.outside((x + dx) % 2) | basis_z.outside((z + dz) % 2))
    masks = [x.any(0), z.any(0), undetected & ~logical, syn_x, syn_z,
             undetected & logical, (ec & CONV_X) != 0, (ec & CONV_Z) != 0]
    total = torch.tensor([ec.shape[0]], device=ec.device)
    return torch.cat([total, torch.stack([m.sum() for m in masks])])


class Reference:
    """The reference for one configuration and traffic mix on a device."""

    def __init__(self, code, traffic: dict, device, dtype=torch.float32,
                 exact=True):
        self.code, self.traffic = code, traffic
        self.device, self.dtype = torch.device(device), dtype
        self.exact = exact
        self.gx, self.gz = Graph(code.x, device), Graph(code.z, device)
        self.bx = Basis(code.harmless_x, device)
        self.bz = Basis(code.harmless_z, device)
        self.h = [(torch.as_tensor(g.dense(), device=device),
                   len(gf2_rref(g.dense())[1])) for g in (code.x, code.z)]

    def replay(self, seed: int, chunks: list[int]):
        """Chunks ``chunks`` of the run seeded ``seed``, decoded together
        (lanes are independent).  Returns (counters (9,) int64 numpy, decode
        records): one record per chunk and decode call, with the call's
        lanes, the sum of their iterations and the largest."""
        tr = self.traffic
        batch, n = tr["batch"], self.code.n
        dev = self.device
        drawn = [errors(tr, n, seed, c, batch, dev) for c in chunks]
        x = torch.cat([d[0] for d in drawn], 1)
        z = torch.cat([d[1] for d in drawn], 1)
        osd = tr.get("osd_lam") is not None
        records = []
        out = {}
        for name, g, bits in (("x", self.gx, x), ("z", self.gz, z)):
            syn = g.syndrome(bits)
            dec, conv, synf, iters, soft = decode(g, syn, tr, self.dtype, osd,
                                                  self.exact)
            records += self._records(g, chunks, iters, False)
            out[name] = [syn, dec, conv, synf, soft]
        if tr.get("relay_retries", 0) > 0:
            for k, name, g in ((0, "x", self.gx), (1, "z", self.gz)):
                records += self._relay(k, g, seed, chunks, out[name])
        ec = (out["x"][3].to(torch.int64) * SYN_X + out["z"][3] * SYN_Z
              + out["x"][2] * CONV_X + out["z"][2] * CONV_Z)
        if osd:
            for bit, name, (h, rank) in ((SYN_X, "x", self.h[0]),
                                         (SYN_Z, "z", self.h[1])):
                syn, dec, _, _, soft = out[name]
                failed = torch.nonzero((ec & bit) != 0).flatten()
                e, solved = osd0(h, rank, syn[:, failed], soft[:, failed])
                dec[:, failed] = torch.where(solved, e, dec[:, failed])
                ec[failed] = torch.where(solved, ec[failed] & ~bit, ec[failed])
        counters = classify(self.bx, self.bz, x, z, out["x"][1], out["z"][1], ec)
        return counters.cpu().numpy().astype(np.int64), records

    def _records(self, g: Graph, chunks, iters, damped):
        batch = self.traffic["batch"]
        per = iters.view(len(chunks), batch)
        sums, maxes = per.sum(1).tolist(), per.max(1).values.tolist()
        algo = "min-sum" if damped else self.traffic["decoder"]["algorithm"]
        return [{"chunk": c, "algorithm": algo, "graph": g.t.kind, "P": g.t.P,
                 "edges": g.t.num_edges, "checks": g.m, "vars": g.n,
                 "lanes": batch, "lane_iters": int(s), "loop_iters": int(mx),
                 "damped": damped}
                for c, s, mx in zip(chunks, sums, maxes)]

    def _relay(self, k: int, g: Graph, seed: int, chunks, state):
        """Relay retries of graph ``k`` for every chunk; updates ``state``
        ([syn, dec, conv, synf, soft]) in place, returns the records."""
        tr = self.traffic
        batch = tr["batch"]
        cfg = tr["decoder"]
        llr = prior_llr(prior_of(tr))
        syn, dec = state[0], state[1]
        solved = ~state[3]
        records = []
        for r in range(tr["relay_retries"]):
            per = solved.view(len(chunks), batch).all(1).tolist()
            active = [i for i, s in enumerate(per) if not s]
            if not active:
                break
            lanes = torch.cat([torch.arange(i * batch, (i + 1) * batch,
                                            device=self.device) for i in active])
            gam = torch.cat([gammas(seed, chunks[i], k, r, g.n, batch,
                                    self.device) for i in active], 1)
            damping = gam.to(self.dtype).index_select(0, g.var_of_flat)
            s_eff = torch.where(solved[lanes], 0, syn[:, lanes])
            v, iters = min_sum(g, s_eff, llr, cfg, self.dtype, damping,
                               self.exact)
            d_new = (g.to_var(v) <= 0.0).any(0).to(torch.uint8)
            ok = ~(g.syndrome(d_new) != syn[:, lanes]).any(0)
            newly = ok & ~solved[lanes]
            dec[:, lanes] = torch.where(newly, d_new, dec[:, lanes])
            solved[lanes] = solved[lanes] | newly
            records += self._records(g, [chunks[i] for i in active], iters, True)
        state[3] = ~solved
        return records
