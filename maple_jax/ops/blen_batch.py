"""Batched on-device branch-length optimization (device compute path).

Maximizes the appendProbNode score in the appending branch length t for a
whole batch of (upper, child) pairs inside one jitted loop — the device
counterpart of the reference's one-branch-at-a-time
``estimateBranchLengthWithDerivative`` (MAPLEv0.7.5.4.py:5040-5358).

The reference extracts per-site coefficients so the derivative of the
log-likelihood is ``-c1 + sum_i 1/(a_i + t)`` and bisects t.  That
derivative is strictly decreasing, i.e. the log-likelihood is strictly
concave in t, and the appendProbNode score differs from it only by
t-independent terms (append skips exactly the shared contributions that
do not involve the appending branch) — so ``argmax_t append_score(t)``
equals the reference optimum.  On the device we therefore golden-section the
batched scorer itself instead of materializing variable-length
coefficient lists: every iteration is two fused elementwise passes over
the padded entry tensors, the canonical trade of cheap recompute for
data-dependent control flow (which batched device code cannot tile).
Verified property (tests/test_blen_batch.py): the device optimum and the
host kernel's bisection agree to bracket tolerance, or the device point
scores at least as well.

Boundary semantics match the host kernel: an optimum within ``sens`` of 0
means "length zero" (the host returns False), and t is capped at 0.1
(reference :5300-region cap).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .append_batch import DeviceModel, _append_scores_impl

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
T_MAX = 0.1


def _iters_for(sens: float, t_max: float = T_MAX) -> int:
    """Golden-section iterations to shrink [0, t_max] below sens."""
    return max(1, int(math.ceil(math.log(sens / t_max) / math.log(_INVPHI))))


@partial(jax.jit, static_argnames=("uer", "iters"))
def _gss_impl(P, C, tips, mm, root_freqs, site_rates, error_rates,
              global_tot_rate, tot_error, uer, iters, sens):
    dtype = mm.dtype
    N = P["types"].shape[0]

    def f(t):
        return _append_scores_impl.__wrapped__(
            P, C, t, tips, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)

    a0 = jnp.zeros((N,), dtype=dtype)
    b0 = jnp.full((N,), T_MAX, dtype=dtype)
    c0 = b0 - _INVPHI * (b0 - a0)
    d0 = a0 + _INVPHI * (b0 - a0)

    def body(_, st):
        # classic golden-section: keep the retained interior point's value
        # and evaluate the scorer only at the ONE new point per iteration
        a, b, c, d, fc, fd = st
        left = fc > fd
        a2 = jnp.where(left, a, c)
        b2 = jnp.where(left, d, b)
        fkeep = jnp.where(left, fc, fd)
        c2 = b2 - _INVPHI * (b2 - a2)
        d2 = a2 + _INVPHI * (b2 - a2)
        # when shrinking left, d2 coincides with the old c (value fkeep)
        # and c2 is new; mirrored on the right
        x = jnp.where(left, c2, d2)
        fx = f(x)
        fc2 = jnp.where(left, fx, fkeep)
        fd2 = jnp.where(left, fkeep, fx)
        return a2, b2, c2, d2, fc2, fd2

    a, b, *_ = jax.lax.fori_loop(0, iters, body,
                                 (a0, b0, c0, d0, f(c0), f(d0)))
    t = 0.5 * (a + b)
    # boundary semantics first (host kernel: <sens means length zero,
    # reference cap at 0.1), then score AT the returned length so the
    # (t, score) pair is consistent
    t = jnp.where(t < sens, jnp.zeros_like(t),
                  jnp.where(t > T_MAX - sens, jnp.full_like(t, T_MAX), t))
    ft = f(t)
    # concavity guard: the uniform-collapse clamp inside the evolve ops is
    # a t-dependent discontinuity where GSS can settle on a non-global
    # bracket (the host kernel escapes this regime via its minAis<0 ->
    # return 0.1 branch); comparing against both endpoints restores the
    # global argmax over {t*, 0, T_MAX}
    f_lo = f(a0)
    f_hi = f(b0)
    better_lo = f_lo > ft
    t = jnp.where(better_lo, a0, t)
    ft = jnp.where(better_lo, f_lo, ft)
    better_hi = f_hi > ft
    t = jnp.where(better_hi, b0, t)
    ft = jnp.where(better_hi, f_hi, ft)
    return t, ft


def batched_optimize_blen(P: dict, C: dict, tips, dm: DeviceModel,
                          sens: float):
    """ML appending branch length for N (upper, child) pairs at once.

    P fields [N,B1] (candidate upper vectors), C fields [N,B2] (child
    lower vectors), ``tips`` scalar or [N] child-is-tip flags, ``sens`` =
    DerivedConfig.minBLenSensitivity (the host bisection's bracket
    precision).  Returns ``(t, score)``: per-pair optimal length (0.0
    where the host kernel would return False, T_MAX at the cap) and the
    append score at that length.
    """
    dtype = dm.mut_matrix.dtype
    return _gss_impl(
        P, C, jnp.asarray(tips), dm.mut_matrix, dm.root_freqs,
        dm.site_rates, dm.error_rates, dm.global_tot_rate, dm.tot_error,
        dm.using_error_rate, _iters_for(sens), jnp.asarray(sens, dtype))
