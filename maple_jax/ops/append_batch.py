"""Batched placement-score kernel (interval algebra, device compute path).

Computes the appendProbNode likelihood cost of attaching one (or many) query
genome lists below many candidate upper vectors in a single XLA call — the
reference scores candidates one at a time in a Python DFS
(MAPLEv0.7.5.4.py:8050); here the candidate axis is the batch axis, which is
what maps this workload onto the device's vector units.

Algorithm: interval algebra instead of two-pointer merges.  Both operands'
entry end-positions are merged into the union breakpoint set (jnp.sort), each
union segment gathers its covering entry from either side (rank-by-counting
instead of searchsorted — dense comparisons vectorize better), and
the {R,N,O,nuc}x{R,N,O,nuc} case matrix is applied as vectorized selects.
Only single-position segments contribute factors (R/R runs and N regions
carry no relative information), so per-segment math is pure 4-vector algebra.

Numerics note: the host kernels accumulate a running product with carry
rescue; this kernel sums log-factors directly.  Equally exact mathematics,
different rounding order — the host path remains the byte-parity reference.
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .pack import PackedBatch, TYPE_N, TYPE_O, TYPE_PAD, TYPE_R


# JAX's persistent compilation cache when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed directory in the checkout (listed in .gitignore) — the
# path is part of the cache key, so a moving directory would never hit.
_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", ".jax_cache")


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache for the device paths.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to the checkout's
    ``.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") \
            or jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir",
                      os.path.normpath(_CACHE_DIR))


class DeviceModel(NamedTuple):
    """Device-resident model state for the batched kernels."""

    mut_matrix: jax.Array      # [4,4] normalized rates
    root_freqs: jax.Array      # [4]
    site_rates: jax.Array      # [lRef] (ones when rate variation is off)
    error_rates: jax.Array     # [lRef] (zeros when error model is off)
    global_tot_rate: jax.Array  # scalar (-lRef)
    tot_error: jax.Array       # scalar
    use_rate_variation: bool   # static
    using_error_rate: bool     # static


def device_model_from(model, dc, dtype=jnp.float32) -> DeviceModel:
    lRef = model.refd.lRef
    site_rates = np.ones(lRef) if model.site_rates is None \
        else np.asarray(model.site_rates)
    error_rates = np.zeros(lRef)
    if model.using_error_rate:
        if model.error_rates is not None:
            error_rates = np.asarray(model.error_rates)
        else:
            error_rates = np.full(lRef, model.error_rate)
    return DeviceModel(
        mut_matrix=jnp.asarray(model.mut_matrix, dtype=dtype),
        root_freqs=jnp.asarray(model.refd.root_freqs, dtype=dtype),
        site_rates=jnp.asarray(site_rates, dtype=dtype),
        error_rates=jnp.asarray(error_rates, dtype=dtype),
        global_tot_rate=jnp.asarray(dc.globalTotRate, dtype=dtype),
        tot_error=jnp.asarray(model.tot_error or 0.0, dtype=dtype),
        use_rate_variation=model.use_rate_variation,
        using_error_rate=model.using_error_rate,
    )


def to_device(p: PackedBatch, dtype=jnp.float32):
    return {
        "types": jnp.asarray(p.types),
        "ends": jnp.asarray(p.ends),
        "vals": jnp.asarray(p.vals),
        "bl1": jnp.asarray(p.bl1, dtype=dtype),
        "bl2": jnp.asarray(p.bl2, dtype=dtype),
        "has_bl1": jnp.asarray(p.has_bl1),
        "has_bl2": jnp.asarray(p.has_bl2),
        "flags": jnp.asarray(p.flags),
        "probs": jnp.asarray(p.probs, dtype=dtype),
    }


def _evolve_o_down(v, t_eff, mm):
    """v + t*(M @ v) with uniform-collapse on negative components
    (reference getPartialVec O branch :4088-4111).  The site rate is folded
    into ``t_eff`` so M stays the constant 4x4 matrix — avoids
    materializing [batch, segments, 4, 4] tensors (HBM-bandwidth killers).
    """
    out = v + t_eff[..., None] * jnp.einsum("ij,...j->...i", mm, v)
    bad = jnp.any(out < 0, axis=-1, keepdims=True)
    return jnp.where(bad, 0.25, out)


def _evolve_nuc_down(h, t_eff, mm, eps, flag):
    """One-hot (or error-emission) vector evolved down a branch of length t
    (reference getPartialVec nuc branches :4112-4141); h is the one-hot of
    the nucleotide, site rate folded into t_eff."""
    e3 = 0.33333 * eps[..., None]
    base = jnp.where(flag[..., None],
                     h * (1.0 - eps[..., None] - e3) + e3,
                     h)
    out = base + t_eff[..., None] * jnp.einsum("ij,...j->...i", mm, base)
    bad = jnp.any(out < 0, axis=-1, keepdims=True)
    return jnp.where(bad, 0.25, out)


def _take(arr, idx):
    return jnp.take_along_axis(arr, idx, axis=-1)


def _append_scores_block(P, C, blen, tip_c, mm, root_freqs, site_rates,
                         error_rates, global_tot_rate, tot_error, uer,
                         gen_offset=None):
    """P fields: [N, B1]; C fields: [N, B2] (pairwise) — scores [N].

    With ``gen_offset`` set (genome-axis sharding, SURVEY.md §5: the dense
    per-site tables are the only O(lRef) state), ``site_rates`` and
    ``error_rates`` are this device's genome slice; only union segments
    whose position falls inside [gen_offset, gen_offset+slice) contribute,
    and the return value is the bare log-factor partial sum — the caller
    psums it over the ``gen`` mesh axis and adds the position-independent
    terms once."""
    N, B1 = P["types"].shape
    B2 = C["types"].shape[-1]
    dtype = mm.dtype
    # per-pair blen/tip vectors ([N]) broadcast over the segment axis
    blen_seg = blen[..., None] if getattr(blen, "ndim", 0) == 1 else blen
    tip_seg = tip_c[..., None] if getattr(tip_c, "ndim", 0) == 1 else tip_c
    endsP = P["ends"]
    endsC = jnp.broadcast_to(C["ends"], (N, B2))
    E = jnp.sort(jnp.concatenate([endsP, endsC], axis=-1), axis=-1)  # [N,S]
    prev = jnp.concatenate([jnp.zeros((N, 1), dtype=E.dtype),
                            E[:, :-1]], axis=-1)
    seg_valid = E > prev

    # Covering-entry "gather" as a one-hot contraction: entry b covers
    # segment s iff prev_end[b] < E[s] <= end[b].  All per-entry fields are
    # packed into one [.., B, F] matrix and gathered with a single einsum —
    # matrix-unit work instead of serialized per-element gathers (the
    # device replacement for the reference's two-pointer walk).
    def field_matrix(X):
        return jnp.stack([
            X["types"].astype(dtype), X["vals"].astype(dtype),
            X["bl1"].astype(dtype), X["bl2"].astype(dtype),
            X["has_bl1"].astype(dtype), X["has_bl2"].astype(dtype),
            X["flags"].astype(dtype),
            X["probs"][..., 0], X["probs"][..., 1],
            X["probs"][..., 2], X["probs"][..., 3],
        ], axis=-1)  # [.., B, 11]

    def segment_gather(ends, fields, E_):
        prev_ends = jnp.concatenate(
            [jnp.zeros_like(ends[..., :1]), ends[..., :-1]], axis=-1)
        onehot = ((prev_ends[..., None, :] < E_[..., :, None])
                  & (ends[..., None, :] >= E_[..., :, None]))
        return jnp.einsum("...sb,...bf->...sf", onehot.astype(dtype),
                          fields)

    segP = segment_gather(endsP, field_matrix(P), E)      # [N,S,11]
    CF = field_matrix(C)
    if C["types"].ndim == 1:
        segC = segment_gather(C["ends"][None, :],
                              CF[None, :, :], E)
    else:
        segC = segment_gather(endsC, CF, E)

    def unpack(seg):
        types = seg[..., 0].astype(jnp.int8)
        vals = seg[..., 1].astype(jnp.int8)
        return (types, vals, seg[..., 2], seg[..., 3], seg[..., 4] > 0.5,
                seg[..., 5] > 0.5, seg[..., 6] > 0.5, seg[..., 7:11])

    cP, valP, blP1, blP2, hasP1, hasP2, flagP, probsP = unpack(segP)
    cC, valC, blC1, _blC2, hasC1, _hasC2, flagC, probsC = unpack(segC)

    is_nucP = cP < 4
    is_nucC = cC < 4
    contributes = seg_valid \
        & (cP != TYPE_N) & (cC != TYPE_N) \
        & (cP != TYPE_PAD) & (cC != TYPE_PAD) \
        & ~((cP == TYPE_R) & (cC == TYPE_R)) \
        & ~(is_nucP & (cP == cC))

    # per-position model state (contributing segments span one position);
    # the site rate scales the whole matrix, so it is folded into the
    # branch lengths instead of materializing per-segment 4x4 matrices
    pos = jnp.maximum(E - 1, 0)
    if gen_offset is None:
        rate = jnp.take(site_rates, pos)
        eps = jnp.take(error_rates, pos) if uer \
            else jnp.zeros_like(rate)
    else:
        span = site_rates.shape[-1]
        lpos = pos - gen_offset
        in_slice = (lpos >= 0) & (lpos < span)
        lpos = jnp.clip(lpos, 0, span - 1)
        rate = jnp.take(site_rates, lpos)
        eps = jnp.take(error_rates, lpos) if uer \
            else jnp.zeros_like(rate)
        contributes = contributes & in_slice

    # total fixed branch length between the two observations
    contrib = blen_seg \
        + jnp.where(cP == TYPE_O,
                    jnp.where(hasP1, blP1, 0.0),
                    jnp.where(hasP2, blP2, jnp.where(hasP1, blP1, 0.0))) \
        + jnp.where(hasC1, blC1, 0.0)
    contrib = contrib.astype(dtype)

    refn = jnp.where(cP == TYPE_R, valC, valP).astype(jnp.int32)
    i1 = jnp.where(is_nucP, cP, refn).astype(jnp.int32)   # P-side nucleotide
    i2 = jnp.where(is_nucC, cC, refn).astype(jnp.int32)   # C-side nucleotide
    flagC_eff = uer & (tip_seg | flagC)
    flagP_eff = flagP if uer else jnp.zeros_like(flagP)

    def ev_o_down(v, t):
        return jnp.where((t > 0)[..., None],
                         _evolve_o_down(v, t * rate, mm), v)

    rf = root_freqs
    gather4 = lambda v, i: jnp.take_along_axis(v, i[..., None],
                                               axis=-1)[..., 0]
    h1 = jax.nn.one_hot(i1, 4, dtype=dtype)
    h2 = jax.nn.one_hot(i2, 4, dtype=dtype)
    m_i1_i2 = rate * jnp.einsum("ij,...i,...j->...", mm, h1, h2)

    evC_O = ev_o_down(probsC, contrib)                      # [N,S,4]
    evC_nuc = _evolve_nuc_down(h2, contrib * rate, mm, eps, flagC_eff)
    evP_root = _evolve_nuc_down(h1, blP1.astype(dtype) * rate, mm,
                                eps, flagP_eff)

    # --- case factors ---
    # A/F) C is O, P is R or nuc
    pcs_i1 = gather4(probsC, i1)
    simple_CO = jnp.where(contrib > 0, gather4(evC_O, i1), pcs_i1)
    root_CO = jnp.einsum("...i,...i,i->...", evC_O, evP_root, rf) \
        / jnp.take(rf, i1)
    f_CO = jnp.where(pcs_i1 > 0.02, pcs_i1,
                     jnp.where(hasP2, root_CO, simple_CO))
    # B/E) both concrete nucleotides (incl. R on one side)
    base_nn = jnp.minimum(0.25, m_i1_i2 * contrib)
    flag_bonus = (flagP_eff.astype(dtype) * (cP != TYPE_R)
                  + flagC_eff.astype(dtype)) * 0.33333 * eps
    plain_nn = base_nn + flag_bonus
    # for the R-parent case the reference adds only the child-side flag
    plain_rn = base_nn + flagC_eff.astype(dtype) * 0.33333 * eps
    root_nn = jnp.einsum("...i,...i,i->...", evC_nuc, evP_root, rf) \
        / jnp.take(rf, i1)
    f_nn = jnp.where(hasP2, root_nn,
                     jnp.where(cP == TYPE_R, plain_rn, plain_nn))
    # C) both O
    f_OO = jnp.einsum("...i,...i->...", probsP, evC_O)
    # D) P is O, C is nuc/R
    pps_i2 = gather4(probsP, i2)
    f_On = jnp.where(pps_i2 > 0.02, pps_i2,
                     jnp.einsum("...i,...i->...", probsP, evC_nuc))

    is_OP = cP == TYPE_O
    is_OC = cC == TYPE_O
    f = jnp.where(is_OP & is_OC, f_OO,
                  jnp.where(is_OP, f_On,
                            jnp.where(is_OC, f_CO, f_nn)))
    f = jnp.where(contributes, f, 1.0)
    log_f = jnp.where(f > 0, jnp.log(jnp.maximum(f, 1e-300)), -jnp.inf)
    if gen_offset is not None:
        return jnp.sum(log_f, axis=-1)
    score = blen * global_tot_rate + jnp.sum(log_f, axis=-1)
    if uer:
        score = score + jnp.where(tip_c, tot_error, 0.0)
    return score


_BLOCK = 256


@partial(jax.jit, static_argnames=("uer",))
def _append_scores_impl(P, C, blen, tip_c, mm, root_freqs, site_rates,
                        error_rates, global_tot_rate, tot_error, uer,
                        gen_offset=None):
    """Chunked driver: maps the block kernel over row-blocks of N so the
    one-hot segment-gather intermediates stay small."""
    N = P["types"].shape[0]
    if N <= _BLOCK:
        return _append_scores_block(P, C, blen, tip_c, mm, root_freqs,
                                    site_rates, error_rates,
                                    global_tot_rate, tot_error, uer,
                                    gen_offset=gen_offset)
    n_blocks = -(-N // _BLOCK)
    pad = n_blocks * _BLOCK - N
    def blockify(v):
        if pad:
            v = jnp.concatenate(
                [v, jnp.repeat(v[:1], pad, axis=0)], axis=0)
        return v.reshape(n_blocks, _BLOCK, *v.shape[1:])
    Pb = {k: blockify(v) for k, v in P.items()}
    paired_C = C["types"].ndim > 1
    Cb = {k: blockify(v) for k, v in C.items()} if paired_C else C
    # per-pair blen/tip vectors ([N], paired mode) must be row-blocked too
    vec_blen = getattr(blen, "ndim", 0) == 1
    vec_tip = getattr(tip_c, "ndim", 0) == 1
    blen_b = blockify(blen) if vec_blen else blen
    tip_b = blockify(tip_c) if vec_tip else tip_c
    def body(args):
        Pblk, Cblk, blb, tpb = args
        return _append_scores_block(Pblk, Cblk, blb, tpb, mm,
                                    root_freqs, site_rates, error_rates,
                                    global_tot_rate, tot_error, uer,
                                    gen_offset=gen_offset)
    def rep(v):
        return jnp.broadcast_to(v, (n_blocks, *getattr(v, "shape", ())))
    out = jax.lax.map(body, (
        Pb,
        Cb if paired_C else jax.tree.map(rep, C),
        blen_b if vec_blen else rep(jnp.asarray(blen)),
        tip_b if vec_tip else rep(jnp.asarray(tip_c))))
    return out.reshape(-1)[:N]


def batched_append_scores(P: dict, C: dict, blen, tip_c: bool,
                          dm: DeviceModel):
    """Scores [N] for appending one query C below each of N candidate upper
    vectors P at distance blen."""
    dtype = dm.mut_matrix.dtype
    return _append_scores_impl(
        P, C, jnp.asarray(blen, dtype=dtype), bool(tip_c), dm.mut_matrix,
        dm.root_freqs, dm.site_rates, dm.error_rates, dm.global_tot_rate,
        dm.tot_error, dm.using_error_rate)


def paired_append_scores(P: dict, C: dict, blen, tips, dm: DeviceModel):
    """Scores [N] for N (candidate, query) pairs: P fields [N,B1] against
    C fields [N,B2]; blen and tips may be scalars or [N] vectors."""
    dtype = dm.mut_matrix.dtype
    return _append_scores_impl(
        P, C, jnp.asarray(blen, dtype=dtype), jnp.asarray(tips),
        dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
        dm.global_tot_rate, dm.tot_error, dm.using_error_rate)


@partial(jax.jit, static_argnames=("uer",))
def _grid_scores_impl(P, C, blen, tip_c, mm, root_freqs, site_rates,
                      error_rates, global_tot_rate, tot_error, uer):
    """All-pairs scores: P fields [N,B1] x C fields [K,B2] -> [K,N].
    Sequential lax.map over queries (each internally row-chunked) keeps
    peak memory at one block's intermediates."""
    def one(Ck):
        return _append_scores_impl.__wrapped__(
            P, Ck, blen, tip_c, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)
    return jax.lax.map(one, C)


def grid_append_scores(P: dict, C: dict, blen, tip_c: bool,
                       dm: DeviceModel):
    """Scores [K,N]: K packed queries against N candidate vectors."""
    dtype = dm.mut_matrix.dtype
    return _grid_scores_impl(
        P, C, jnp.asarray(blen, dtype=dtype), bool(tip_c), dm.mut_matrix,
        dm.root_freqs, dm.site_rates, dm.error_rates, dm.global_tot_rate,
        dm.tot_error, dm.using_error_rate)


@partial(jax.jit, static_argnames=("uer",))
def _grid_scores_var_impl(P, C, blens, tips, mm, root_freqs, site_rates,
                          error_rates, global_tot_rate, tot_error, uer):
    """All-pairs scores with per-query branch length and tip flag:
    P fields [N,B1] x C fields [K,B2], blens [K], tips [K] -> [K,N]."""
    def one(args):
        Ck, bl, tp = args
        return _append_scores_impl.__wrapped__(
            P, Ck, bl, tp, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)
    return jax.lax.map(one, (C, blens, tips))


def grid_append_scores_var(P: dict, C: dict, blens, tips,
                           dm: DeviceModel):
    """Scores [K,N]: K packed queries — each carrying its own appending
    branch length and tip flag (the SPR screen's pruned subtrees keep
    their current attachment blen; placement queries are always tips at
    oneMut) — against N candidate vectors."""
    dtype = dm.mut_matrix.dtype
    return _grid_scores_var_impl(
        P, C, jnp.asarray(blens, dtype=dtype),
        jnp.asarray(tips, dtype=bool), dm.mut_matrix, dm.root_freqs,
        dm.site_rates, dm.error_rates, dm.global_tot_rate, dm.tot_error,
        dm.using_error_rate)
