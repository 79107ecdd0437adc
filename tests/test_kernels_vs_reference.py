"""Differential fuzzing of maple_jax.core.kernels against the reference
implementation (imported as a module and used as an oracle).

Every hot kernel is driven with randomized — but structurally valid — genome
lists across all model modes (error rate on/off, site-specific or global,
rate variation on/off, upDown or lower merges) and the outputs are compared
for exact tuple equality / exact float equality, since both implementations
perform the same arithmetic in the same order.
"""
import random

import pytest

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.core import genomelist as gl
from maple_jax.core import kernels as K
from maple_jax.refdata import Model, RefData


# ---------------------------------------------------------------- helpers

# the Model used by the most recent build_ctx call (native-kernel tests
# need the exact float state, not a reconstruction)
last_built_model = [None]


def build_ctx(refmod, model_name="GTR", use_rate_variation=False,
              error_mode="none", seed=0):
    """Build (my KernelCtx, configured reference module) with identical
    model state."""
    rng = random.Random(seed)
    refd = RefData.build(refmod.ref, model=model_name)
    model = Model.initial(refd, model_name)
    if use_rate_variation:
        model.site_rates = [0.2 + 1.6 * rng.random() for _ in range(refd.lRef)]
        model.refresh_cumulative_rate()
    if error_mode == "global":
        model.set_error_rates(2e-4, None)
    elif error_mode == "site":
        model.set_error_rates(
            2e-4, [rng.random() * 4e-4 for _ in range(refd.lRef)])
    cfg = MapleConfig(model=model_name)
    dc = DerivedConfig.build(cfg, refd.lRef)
    ctx = K.KernelCtx(refd, model, dc)
    last_built_model[0] = model

    # configure the reference module's globals to the same state
    refmod.mutMatrixGlobal = model.mut_matrix
    refmod.errorRateGlobal = model.error_rate
    refmod.usingErrorRate = model.using_error_rate
    refmod.errorRateSiteSpecific = model.error_rate_site_specific
    refmod.useRateVariation = model.use_rate_variation
    refmod.mutMatrices = model.mut_matrices
    refmod.errorRates = model.error_rates
    refmod.cumulativeErrorRate = model.cumulative_error_rate
    refmod.totError = model.tot_error
    refmod.rootFreqsLogErrorCumulative = model.root_freqs_log_error_cumulative
    refmod.cumulativeRate = model.cumulative_rate
    refmod.nonMutRates = [model.mut_matrix[i][i] for i in range(4)]
    refmod.rootFreqs = refd.root_freqs
    refmod.rootFreqsLog = refd.root_freqs_log
    return ctx, refmod


def random_genome_list(rng, lRef, uer, upper=False, max_entries=14):
    """Generate a structurally valid random genome list.

    Lower lists carry at most one branch length per entry; upper lists may
    carry root-crossing (two-length) entries.  O vectors are normalized.
    """
    n_special = rng.randint(0, max_entries)
    positions = sorted(rng.sample(range(1, lRef + 1), n_special))
    out = []
    pos = 1  # next uncovered position

    def rand_bl():
        r = rng.random()
        if r < 0.4:
            return None
        return rng.choice([0.0, rng.random() * 3e-4, rng.random() * 3e-3])

    def nuc_fields(force_flag_with_bl=False):
        """extra fields after (code, val)"""
        bl1 = rand_bl()
        fields = ()
        if bl1 is not None:
            fields = (bl1,)
            if upper and rng.random() < 0.35:
                fields = (bl1, rng.choice([0.0, rng.random() * 3e-4]))
        if uer:
            if fields or rng.random() < 0.0:
                fields = fields + (rng.random() < 0.5,)
            # bare entries stay bare: flag only accompanies lengths
        return fields

    for p in positions:
        if p < pos:
            continue  # already covered by a previous N run
        if p > pos:
            # R run [pos, p-1]
            fields = nuc_fields()
            out.append((4, p - 1) + fields)
            pos = p
        kind = rng.random()
        if kind < 0.3:
            # N run of random length
            end = min(lRef, p + rng.randint(0, 30))
            out.append((5, end))
            pos = end + 1
        elif kind < 0.75:
            # concrete nucleotide different from (fake) ref
            ref_nuc = rng.randint(0, 3)
            nuc = rng.choice([x for x in range(4) if x != ref_nuc])
            out.append((nuc, ref_nuc) + nuc_fields())
            pos = p + 1
        else:
            # O entry
            vec = [rng.random() for _ in range(4)]
            if rng.random() < 0.5:
                # concentrate on 2 states
                vec = [v if i in (0, 1) else v * 1e-3 for i, v in enumerate(vec)]
            s = sum(vec)
            vec = [v / s for v in vec]
            ref_nuc = rng.randint(0, 3)
            if rng.random() < 0.5:
                out.append((6, ref_nuc, vec))
            else:
                out.append((6, ref_nuc, rng.random() * 3e-4, vec))
            pos = p + 1
    if pos <= lRef:
        out.append((4, lRef) + nuc_fields())
    # guarantee listed invariant
    assert gl.genome_list_length_check(lRef, out)
    return out


MODES = [
    ("GTR", False, "none"),
    ("UNREST", False, "none"),
    ("GTR", True, "none"),
    ("GTR", False, "global"),
    ("GTR", True, "site"),
]


def _tuples_equal(a, b, tol=0.0):
    if a is None or b is None:
        return a is None and b is None
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, list) or isinstance(y, list):
            if len(x) != len(y) or any(xx != yy for xx, yy in zip(x, y)):
                return False
        elif x != y:
            return False
    return True


def assert_lists_equal(mine, ref, label=""):
    assert (mine is None) == (ref is None), f"{label}: None mismatch"
    if mine is None:
        return
    assert len(mine) == len(ref), \
        f"{label}: length {len(mine)} vs {len(ref)}\n{mine}\n{ref}"
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert _tuples_equal(m, tuple(r)), \
            f"{label}: entry {i}: {m} vs {r}"


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_merge_vectors_lower(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=1)
    rng = random.Random(42)
    for trial in range(120):
        v1 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        v2 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        bl1 = rng.choice([0.0, 1e-4, 3.3e-5, rng.random() * 1e-3])
        bl2 = rng.choice([0.0, 1e-4, rng.random() * 1e-3])
        tip1 = rng.random() < 0.5
        tip2 = rng.random() < 0.5
        ref_out = rm.mergeVectors(v1, bl1, tip1, v2, bl2, tip2)
        my_out = K.merge_vectors(ctx, v1, bl1, tip1, v2, bl2, tip2)
        assert_lists_equal(my_out, ref_out, f"merge lower trial {trial}")


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_merge_vectors_updown(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=2)
    rng = random.Random(43)
    for trial in range(120):
        v1 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True)
        v2 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        bl1 = rng.choice([0.0, 1e-4, rng.random() * 1e-3])
        bl2 = rng.choice([0.0, 1e-4, rng.random() * 1e-3])
        tip2 = rng.random() < 0.5
        ref_out = rm.mergeVectors(v1, bl1, False, v2, bl2, tip2,
                                  isUpDown=True)
        my_out = K.merge_vectors(ctx, v1, bl1, False, v2, bl2, tip2,
                                 is_up_down=True)
        assert_lists_equal(my_out, ref_out, f"merge upDown trial {trial}")


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_merge_vectors_return_lk(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=3)
    rng = random.Random(44)
    n_ok = 0
    for trial in range(120):
        v1 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        v2 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        bl1 = rng.choice([1e-4, rng.random() * 1e-3])
        bl2 = rng.choice([1e-4, rng.random() * 1e-3])
        tip1 = rng.random() < 0.5
        tip2 = rng.random() < 0.5
        nm1 = rng.randint(0, 3)
        nm2 = rng.randint(0, 3)
        ref_out, ref_lk = rm.mergeVectors(v1, bl1, tip1, v2, bl2, tip2,
                                          returnLK=True, numMinor1=nm1,
                                          numMinor2=nm2)
        my_out, my_lk = K.merge_vectors(ctx, v1, bl1, tip1, v2, bl2, tip2,
                                        return_lk=True, n_minor1=nm1,
                                        n_minor2=nm2)
        assert_lists_equal(my_out, ref_out, f"merge LK trial {trial}")
        assert my_lk == ref_lk, f"LK mismatch {my_lk} vs {ref_lk}"
        n_ok += 1
    assert n_ok


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_append_prob_node(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=4)
    rng = random.Random(45)
    for trial in range(200):
        vP = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True)
        vC = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        blen = rng.choice([0.0, 3.3e-5, 1e-4, rng.random() * 1e-3])
        is_tip = rng.random() < 0.5
        ref_lk = rm.appendProbNode(vP, vC, is_tip, blen)
        my_lk = K.append_prob_node(ctx, vP, vC, is_tip, blen)
        assert my_lk == ref_lk, \
            f"append trial {trial}: {my_lk} vs {ref_lk}"


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_estimate_branch_length(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=5)
    rng = random.Random(46)
    for trial in range(200):
        vP = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True)
        vC = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        from_tip = rng.random() < 0.5
        ref_t = rm.estimateBranchLengthWithDerivative(vP, vC,
                                                      fromTipC=from_tip)
        my_t = K.estimate_branch_length(ctx, vP, vC, from_tip_c=from_tip)
        assert my_t == ref_t, f"blen trial {trial}: {my_t} vs {ref_t}"


class _FakeTree:
    """Minimal stand-in for reference rootVector/findProbRoot tree access:
    single node, no MAT mutations."""

    def __init__(self):
        self.mutations = [[]]
        self.up = [None]


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_root_vector_and_prob_root(refmod, model_name, rate_var, error_mode):
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=6)
    rng = random.Random(47)
    tree = _FakeTree()
    for trial in range(100):
        v = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        blen = rng.choice([0.0, False, 1e-4, rng.random() * 1e-3])
        from_tip = rng.random() < 0.5
        ref_out = rm.rootVector(v, blen, from_tip, tree, 0)
        my_out = K.root_vector_frame(ctx, v, blen, from_tip)
        gl.shorten(my_out, ctx.threshold_prob)
        assert_lists_equal(my_out, ref_out, f"rootVector trial {trial}")

        ref_lk = rm.findProbRoot(v)
        my_lk = K.find_prob_root_frame(ctx, v)
        assert my_lk == ref_lk, f"findProbRoot trial {trial}"


def test_are_vectors_different(refmod):
    ctx, rm = build_ctx(refmod, "GTR", False, "none", seed=7)
    rng = random.Random(48)
    n_same = n_diff = 0
    for trial in range(300):
        v1 = random_genome_list(rng, ctx.lRef, False)
        if rng.random() < 0.3:
            v2 = [tuple(e) for e in v1]
            if rng.random() < 0.5 and len(v2) > 1:
                # small perturbation of one branch length / O value
                i = rng.randrange(len(v2))
                e = v2[i]
                if len(e) > 2 and not isinstance(e[-1], list) \
                        and isinstance(e[2], float):
                    delta = rng.choice([1e-9, 1e-6, 1e-3])
                    v2[i] = (e[0], e[1], e[2] + delta) + e[3:]
        else:
            v2 = random_genome_list(rng, ctx.lRef, False)
        ref_r = rm.areVectorsDifferent(v1, v2)
        my_r = K.are_vectors_different(ctx, v1, v2)
        assert my_r == ref_r, f"areVectorsDifferent trial {trial}"
        n_same += 0 if ref_r else 1
        n_diff += 1 if ref_r else 0
    assert n_same and n_diff  # both outcomes exercised


def test_shorten_and_pass_through_branch(refmod):
    ctx, rm = build_ctx(refmod, "GTR", False, "none", seed=8)
    rng = random.Random(49)
    for trial in range(200):
        v = random_genome_list(rng, ctx.lRef, False, upper=True)
        mine = [tuple(e) for e in v]
        theirs = [tuple(e) for e in v]
        gl.shorten(mine, ctx.threshold_prob)
        rm.shorten(theirs)
        assert_lists_equal(mine, theirs, f"shorten trial {trial}")

        # random MAT mutation list: (pos, upper_nuc, lower_nuc)
        n_mut = rng.randint(0, 8)
        muts = []
        for p in sorted(rng.sample(range(1, ctx.lRef + 1), n_mut)):
            a, b = rng.sample(range(4), 2)
            muts.append((p, a, b))
        for dir_up in (False, True):
            ref_out = rm.passGenomeListThroughBranch(v, muts, dirIsUp=dir_up)
            my_out = gl.pass_through_branch(ctx.lRef, v, muts,
                                            dir_is_up=dir_up)
            assert_lists_equal(my_out, ref_out,
                               f"passThroughBranch trial {trial} up={dir_up}")


def test_simplify(refmod):
    ctx, rm = build_ctx(refmod, "GTR", False, "none", seed=9)
    rng = random.Random(50)
    for _ in range(300):
        vec = [rng.random() for _ in range(4)]
        if rng.random() < 0.5:
            keep = rng.randrange(4)
            vec = [v if i == keep else v * 1e-12 for i, v in enumerate(vec)]
        s = sum(vec)
        vec = [v / s for v in vec]
        ref_nuc = rng.randrange(4)
        assert gl.simplify(vec, ref_nuc, ctx.threshold_prob,
                           ctx.threshold_prob4) == rm.simplify(vec, ref_nuc)
