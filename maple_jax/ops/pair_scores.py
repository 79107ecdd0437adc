"""Exact batched placement scoring (appendProbNode) by entry pairs.

The pair-formulation twin of
:func:`maple_jax.ops.append_batch._append_scores_block` (reference
semantics: MAPLEv0.7.5.4.py:6505-6785).  Same mathematics, different
decomposition:

Entry-pair identity.  The interval-algebra kernel materializes the union
breakpoint set (jnp.sort) and gathers each segment's covering entries with
a one-hot contraction.  This kernel uses the fact that genome-list entries
partition [0, lRef], so every union segment is the overlap of exactly one
(P-entry, C-entry) pair — between ``max(prev_ends)`` and ``min(ends)`` of
an overlapping pair there can be no other breakpoint.  Scoring therefore
needs no sort and no gather: it is a masked sum of per-pair log-factors
over the B1 x B2 entry grid, pure element-wise work.

Layout.  Candidate fields are stacked host-side into one [N, F, B1] tensor
(:func:`stack_fields_host`), queries into [K, 1, B2*F].  The step walks the
B2 query entries with a ``fori_loop`` (vmapped over queries); each
iteration evaluates the per-pair factor chain over the [N, B1] candidate
planes and folds the B1 sum in at once, so only a [K, N] accumulator lives
across the loop (each iteration is two kernels: the fused factor chain,
then the sum).  The loop
stops after the last query entry that can contribute (N runs and padding
— most of a padded tip list — contribute nothing).  Per-site model state
(site rates, error rates) is pre-gathered per entry outside the step — the
rate of a contributing pair is the rate at ``min(ends) - 1``, so a
per-entry gather plus a select replaces a table lookup.

Numerics match the interval-algebra kernel up to summation order (both sum
log-factors; the host path's carry-rescue product remains the byte-parity
reference).  Tests compare against the native host kernels in float64.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .pack import TYPE_N, TYPE_O, TYPE_PAD, TYPE_R

# field order in the stacked entry tensors
_F_TYPE, _F_VAL, _F_BL1, _F_BL2, _F_HAS1, _F_HAS2, _F_FLAG = range(7)
_F_P0, _F_P1, _F_P2, _F_P3 = 7, 8, 9, 10
_F_END, _F_PREV, _F_RATE, _F_EPS = 11, 12, 13, 14
_NFIELDS = 16  # padded to a power of two


def stack_fields_host(p, site_rates, error_rates, axis, dtype=None):
    """Host (numpy) twin of :func:`_stack_fields`: stack a PackedBatch's
    per-entry fields — plus the derived end/prev/rate/eps planes — into
    the kernel's _NFIELDS layout, so a device upload is ONE array instead
    of nine.  Per-entry site rate and error rate are baked in at pack
    time; they are constant during placement and during an SPR screen
    pass (both only change at EM boundaries).

    axis=-2 packs candidates ([N, F, B]); axis=-1 packs queries
    ([..., B, F])."""
    import numpy as np
    dtype = dtype or np.float32
    ends = p.ends
    pos = np.maximum(ends - 1, 0)
    prev = np.concatenate(
        [np.zeros_like(ends[..., :1]), ends[..., :-1]], axis=-1)
    rate = (np.ones_like(ends, dtype=dtype) if site_rates is None
            else np.asarray(site_rates)[pos])
    eps = (np.zeros_like(ends, dtype=dtype) if error_rates is None
           else np.asarray(error_rates)[pos])
    fields = [
        p.types, p.vals, p.bl1, p.bl2, p.has_bl1, p.has_bl2, p.flags,
        p.probs[..., 0], p.probs[..., 1], p.probs[..., 2], p.probs[..., 3],
        ends, prev, rate, eps, np.zeros_like(ends),
    ]
    return np.stack([np.asarray(f, dtype=dtype) for f in fields],
                    axis=axis)


def _stack_fields(X, site_rates, error_rates, axis):
    """Stack the packed dict's per-entry fields into one tensor along
    ``axis`` (-2 for P: [N, F, B1]; -1 for C: [.., B2, F])."""
    dtype = X["bl1"].dtype
    ends = X["ends"]
    pos = jnp.maximum(ends - 1, 0)
    prev = jnp.concatenate(
        [jnp.zeros_like(ends[..., :1]), ends[..., :-1]], axis=-1)
    fields = [
        X["types"].astype(dtype), X["vals"].astype(dtype),
        X["bl1"].astype(dtype), X["bl2"].astype(dtype),
        X["has_bl1"].astype(dtype), X["has_bl2"].astype(dtype),
        X["flags"].astype(dtype),
        X["probs"][..., 0], X["probs"][..., 1],
        X["probs"][..., 2], X["probs"][..., 3],
        ends.astype(dtype), prev.astype(dtype),
        jnp.take(site_rates, pos).astype(dtype),
        jnp.take(error_rates, pos).astype(dtype),
        jnp.zeros_like(ends, dtype=dtype),
    ]
    return jnp.stack(fields, axis=axis)


def _pair_log_factors(fP, g, mm, rf, blen, tip, *, uer):
    """Per-pair log factors of one query entry against the candidate
    planes.  ``fP(i)`` returns candidate field i as a plane (any shape);
    ``g(i)`` returns the query entry's field i as a scalar.  Returns the
    log factors in the plane shape (0 where the pair does not
    contribute)."""
    cP = fP(_F_TYPE)
    dtype = cP.dtype
    valP = fP(_F_VAL)
    blP1 = fP(_F_BL1)
    blP2 = fP(_F_BL2)
    hasP1 = fP(_F_HAS1) > 0.5
    hasP2 = fP(_F_HAS2) > 0.5
    flagP = fP(_F_FLAG) > 0.5
    pP = [fP(_F_P0 + k) for k in range(4)]
    endP = fP(_F_END)
    prevP = fP(_F_PREV)
    rateP = fP(_F_RATE)
    epsP = fP(_F_EPS)

    is_nucP = cP < 3.5
    is_R_P = cP == float(TYPE_R)
    is_O_P = cP == float(TYPE_O)
    dead_P = (cP == float(TYPE_N)) | (cP == float(TYPE_PAD))
    zero = jnp.zeros(cP.shape, dtype)

    def onehot4(idx):
        return [(idx == float(k)).astype(dtype) for k in range(4)]

    def mv(v):
        return [mm[k][0] * v[0] + mm[k][1] * v[1]
                + mm[k][2] * v[2] + mm[k][3] * v[3] for k in range(4)]

    def evolve_down(base, t_eff):
        m = mv(base)
        out = [base[k] + t_eff * m[k] for k in range(4)]
        bad = (out[0] < 0) | (out[1] < 0) | (out[2] < 0) | (out[3] < 0)
        return [jnp.where(bad, 0.25, out[k]) for k in range(4)]

    dot4 = lambda a, b: (a[0] * b[0] + a[1] * b[1]
                         + a[2] * b[2] + a[3] * b[3])

    cC = g(_F_TYPE)
    valC = g(_F_VAL)
    blC1 = g(_F_BL1)
    hasC1 = g(_F_HAS1) > 0.5
    flagC = g(_F_FLAG) > 0.5
    pC = [g(_F_P0 + k) for k in range(4)]
    endC = g(_F_END)
    prevC = g(_F_PREV)
    rateC = g(_F_RATE)
    epsC = g(_F_EPS)
    is_nucC = cC < 3.5
    is_O_C = cC == float(TYPE_O)

    overlap = (jnp.minimum(endP, endC)
               - jnp.maximum(prevP, prevC)) > 0.5
    contributes = overlap & ~dead_P \
        & ~(is_R_P & (cC == float(TYPE_R))) \
        & ~(is_nucP & (cP == cC))

    # per-position model state: position = min(ends) - 1
    p_side = endP <= endC
    rate = jnp.where(p_side, rateP, rateC)
    eps = jnp.where(p_side, epsP, epsC) if uer else zero

    contrib = blen \
        + jnp.where(is_O_P,
                    jnp.where(hasP1, blP1, 0.0),
                    jnp.where(hasP2, blP2,
                              jnp.where(hasP1, blP1, 0.0))) \
        + jnp.where(hasC1, blC1, 0.0)

    refn = jnp.where(is_R_P, valC, valP)
    i1 = jnp.where(is_nucP, cP, refn)
    i2 = jnp.where(is_nucC, cC, refn)
    h1 = onehot4(i1)
    h2 = onehot4(i2)
    if uer:
        fCh = ((tip > 0.5) | flagC).astype(dtype)
        fPh = flagP.astype(dtype)
    else:
        fCh = jnp.asarray(0.0, dtype)
        fPh = zero

    t_eff = contrib * rate
    pos_t = contrib > 0
    # C is O: evolve its explicit 4-vector down contrib
    evC_O_raw = evolve_down([pC[k] + zero for k in range(4)], t_eff)
    evC_O = [jnp.where(pos_t, evC_O_raw[k], pC[k]) for k in range(4)]
    # C is concrete: evolve its (error-adjusted) one-hot
    e3 = 0.33333 * eps
    baseC = [fCh * (h2[k] * (1.0 - eps - e3) + e3)
             + (1.0 - fCh) * h2[k] for k in range(4)]
    evC_nuc = evolve_down(baseC, t_eff)
    # P root-side half branch (two-length entries)
    baseP = [fPh * (h1[k] * (1.0 - eps - e3) + e3)
             + (1.0 - fPh) * h1[k] for k in range(4)]
    evP_root = evolve_down(baseP, blP1 * rate)

    rf_i1 = dot4(h1, rf)
    m_i1_i2 = rate * dot4(h1, mv(h2))

    # --- case factors (same ordering as the interval-algebra kernel) ---
    pcs_i1 = dot4(h1, pC)
    simple_CO = jnp.where(pos_t, dot4(h1, evC_O), pcs_i1)
    root_CO = (evC_O[0] * evP_root[0] * rf[0]
               + evC_O[1] * evP_root[1] * rf[1]
               + evC_O[2] * evP_root[2] * rf[2]
               + evC_O[3] * evP_root[3] * rf[3]) / rf_i1
    f_CO = jnp.where(pcs_i1 > 0.02, pcs_i1,
                     jnp.where(hasP2, root_CO, simple_CO))

    base_nn = jnp.minimum(0.25, m_i1_i2 * contrib)
    not_R = (~is_R_P).astype(dtype)
    plain_nn = base_nn + (fPh * not_R + fCh) * 0.33333 * eps
    plain_rn = base_nn + fCh * 0.33333 * eps
    root_nn = (evC_nuc[0] * evP_root[0] * rf[0]
               + evC_nuc[1] * evP_root[1] * rf[1]
               + evC_nuc[2] * evP_root[2] * rf[2]
               + evC_nuc[3] * evP_root[3] * rf[3]) / rf_i1
    f_nn = jnp.where(hasP2, root_nn,
                     jnp.where(is_R_P, plain_rn, plain_nn))

    f_OO = dot4(pP, evC_O)
    pps_i2 = dot4(h2, pP)
    f_On = jnp.where(pps_i2 > 0.02, pps_i2, dot4(pP, evC_nuc))

    fac = jnp.where(is_O_P & is_O_C, f_OO,
                    jnp.where(is_O_P, f_On,
                              jnp.where(is_O_C, f_CO, f_nn)))
    fac = jnp.where(contributes, fac, 1.0)
    return jnp.where(fac > 0, jnp.log(jnp.maximum(fac, 1e-300)),
                     jnp.asarray(-jnp.inf, dtype))


def pair_scores_prestacked(Pstk, Cflat, prm, mm_flat, rf, *, uer):
    """Exact scores [K, N] over pre-stacked inputs — traced inside the
    caller's jit, so scatter + screen + top-k stay ONE dispatch.

    Pstk [N, F, B1] stacked candidate fields (see
    :func:`stack_fields_host`); Cflat [K, 1, B2*F] stacked query fields;
    prm [K, 1, 4] per-query (blen, tip, global_tot_rate, tot_error);
    mm_flat [1, 1, 16]; rf [1, 1, 4]."""
    K = Cflat.shape[0]
    B2 = Cflat.shape[-1] // _NFIELDS
    C = Cflat.reshape(K, B2, _NFIELDS)
    planes = [Pstk[:, i, :] for i in range(_NFIELDS)]     # [N, B1] each
    mmv = mm_flat.reshape(16)
    mm = [[mmv[4 * i + j] for j in range(4)] for i in range(4)]
    rfl = [rf.reshape(4)[k] for k in range(4)]
    prm = prm.reshape(K, 4)
    ctype = C[..., _F_TYPE]
    active = (ctype != float(TYPE_N)) & (ctype != float(TYPE_PAD))
    # entries past the last active one (padding) never contribute: stop
    # the loop there instead of walking the padded budget
    n_hi = jnp.max(jnp.where(active, jnp.arange(1, B2 + 1), 0))

    def one_query(c_k, act_k, prm_k):
        def body(j, acc):
            row = c_k[j]
            logs = _pair_log_factors(lambda i: planes[i],
                                     lambda i: row[i], mm, rfl,
                                     prm_k[0], prm_k[1], uer=uer)
            # the factor chain and the B1 sum compile as two kernels: fused
            # into one reduction, the GPU compiler took over 5 minutes
            logs = jax.lax.optimization_barrier(logs)
            return acc + jnp.where(act_k[j], jnp.sum(logs, axis=-1), 0.0)
        return jax.lax.fori_loop(0, n_hi, body,
                                 jnp.zeros(Pstk.shape[0], Pstk.dtype))

    scores = jax.vmap(one_query)(C, active, prm)          # [K, N]
    scores = scores + (prm[:, 0] * prm[:, 2])[:, None]
    if uer:
        scores = scores + (prm[:, 1] * prm[:, 3])[:, None]
    return scores


@partial(jax.jit, static_argnames=("uer",))
def _pair_scores_impl(P, C, blen, tip_c, mm, root_freqs, site_rates,
                      error_rates, global_tot_rate, tot_error, uer):
    dtype = mm.dtype
    Pstk = _stack_fields(P, site_rates, error_rates, axis=-2)  # [N,F,B1]
    Cstk = _stack_fields(C, site_rates, error_rates, axis=-1)  # [K,B2,F]
    if Cstk.ndim == 2:
        Cstk = Cstk[None]
    K, B2, _ = Cstk.shape
    Cflat = Cstk.reshape(K, 1, B2 * _NFIELDS)
    # per-query params: blen/tip may be scalars (placement: every query is
    # a tip at the same length) or [K] vectors (SPR screen: each pruned
    # subtree keeps its own attachment length and tip flag)
    blen_k = jnp.broadcast_to(jnp.asarray(blen, dtype).reshape(-1), (K,))
    tip_k = jnp.broadcast_to(jnp.asarray(tip_c, dtype).reshape(-1), (K,))
    prm = jnp.stack(
        [blen_k, tip_k,
         jnp.broadcast_to(global_tot_rate.astype(dtype), (K,)),
         jnp.broadcast_to(tot_error.astype(dtype), (K,))],
        axis=-1).reshape(K, 1, 4)
    return pair_scores_prestacked(Pstk, Cflat, prm,
                                  mm.reshape(1, 1, 16).astype(dtype),
                                  root_freqs.reshape(1, 1, 4).astype(dtype),
                                  uer=uer)


def grid_pair_scores(P: dict, C: dict, blens, tips, dm):
    """Scores [K, N] for K packed queries against N candidate uppers;
    ``blens``/``tips`` are scalars or per-query [K] vectors (the SPR
    screen's call shape: each pruned subtree keeps its attachment
    length and tip flag)."""
    dtype = dm.mut_matrix.dtype
    return _pair_scores_impl(
        P, C, jnp.asarray(blens, dtype), jnp.asarray(tips).astype(dtype),
        dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
        dm.global_tot_rate, dm.tot_error, dm.using_error_rate)
