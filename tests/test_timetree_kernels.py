"""Differential tests: time-tree kernels vs the reference implementation
(functions extracted from the reference's __main__-guarded region)."""
import random
import textwrap

import pytest

from conftest import REFERENCE_PATH, load_reference_module
from maple_jax.models.timetree import (TimeCtx, append_prob_node_time,
                                       are_vectors_different_time,
                                       is_minor_date, merge_vectors_time,
                                       read_dates, root_vector_time,
                                       sort_samples_by_date)

LREF = 29903
INTERVAL = 7
THR = 0.0001
MUT_RATE = 0.09 * INTERVAL


def _extract(refmod, name):
    lines = open(REFERENCE_PATH).readlines()
    for i, l in enumerate(lines):
        if l.startswith("\tdef " + name + "(") \
                or l.startswith("\t\tdef " + name + "("):
            start = i
            tabs = l.index("def")
            break
    else:
        raise KeyError(name)
    end = start + 1
    while end < len(lines):
        l = lines[end]
        if l.strip() and (not l.startswith("\t" * (tabs + 1))):
            break
        end += 1
    exec(textwrap.dedent("".join(lines[start:end])), refmod.__dict__)


@pytest.fixture(scope="module")
def reftime():
    refmod = load_reference_module()
    refmod.timeProbThreshold = THR
    refmod.timeProbThreshold2 = THR * THR
    refmod.poissonCoeff = [[1.0]]
    refmod.intervalLength = INTERVAL
    refmod.minMutRate = 0.03
    from math import ceil, exp, floor, log
    refmod.floor = floor
    refmod.ceil = ceil
    refmod.exp = exp
    refmod.log = log
    for nm in ("getPoissonCoeff", "getPartialVecTime", "mergeVectorsTime",
               "rootVectorTime", "areVectorsDifferentTime",
               "appendProbNodeTime", "isMinorDate"):
        _extract(refmod, nm)
    return refmod


def _ctx():
    return TimeCtx(LREF, MUT_RATE, INTERVAL, THR, 0.03, 0.09)


def random_time_vector(rng, lo=0, hi=10):
    kind = rng.random()
    if kind < 0.15:
        return None
    max_t = rng.randrange(lo + 2, hi)
    if kind < 0.3:
        return (max_t,)
    span = rng.randrange(0, 6)
    min_t = max_t - span
    if kind < 0.4:
        return (max_t, min_t)
    pv = [rng.random() + 1e-6 for _ in range(span + 1)]
    tot = sum(pv)
    pv = [x / tot for x in pv]
    return (max_t, min_t, pv)


def random_blen(rng):
    r = rng.random()
    if r < 0.3:
        return 0.0
    if r < 0.6:
        return rng.randrange(1, 5) / LREF  # integer mutation counts
    return rng.random() * 8 / LREF


def test_merge_vectors_time_matches_reference(reftime):
    rng = random.Random(1)
    checked = 0
    for trial in range(400):
        ctx = _ctx()
        reftime.poissonCoeff = [[1.0]]
        v1 = random_time_vector(rng)
        v2 = random_time_vector(rng)
        bl1 = random_blen(rng)
        bl2 = random_blen(rng)
        updown = rng.random() < 0.5
        if updown and v1 is not None and len(v1) < 3:
            continue  # upper vectors always carry probV in practice
        try:
            ref = reftime.mergeVectorsTime(v1, bl1, v2, bl2, MUT_RATE,
                                           returnLK=True, isUpDown=updown)
        except Exception:
            continue
        mine = merge_vectors_time(ctx, v1, bl1, v2, bl2, return_lk=True,
                                  is_up_down=updown)
        if ref == float("-inf"):
            # reference returns a bare -inf on incompatibility (which its
            # own callers crash on); we return (marker, -inf) instead
            assert isinstance(mine, tuple) and mine[1] == float("-inf")
        else:
            assert mine == ref, (v1, bl1, v2, bl2, updown)
        checked += 1
    assert checked > 100


def test_append_prob_node_time_matches_reference(reftime):
    rng = random.Random(2)
    checked = 0
    for trial in range(400):
        ctx = _ctx()
        reftime.poissonCoeff = [[1.0]]
        vP = random_time_vector(rng)
        vC = random_time_vector(rng)
        if vP is not None and len(vP) < 3:
            continue
        blen = random_blen(rng)
        try:
            ref = reftime.appendProbNodeTime(vP, vC, MUT_RATE, blen)
        except Exception:
            continue
        mine = append_prob_node_time(ctx, vP, vC, blen)
        assert mine == ref, (vP, vC, blen)
        checked += 1
    assert checked > 100


def test_root_vector_time_matches_reference(reftime):
    rng = random.Random(3)
    checked = 0
    for trial in range(200):
        ctx = _ctx()
        reftime.poissonCoeff = [[1.0]]
        v = random_time_vector(rng)
        if v is None:
            continue
        blen = random_blen(rng)
        ref = reftime.rootVectorTime(v, blen, MUT_RATE, returnLK=True)
        mine = root_vector_time(ctx, v, blen, return_lk=True)
        assert mine == ref, (v, blen)
        checked += 1
    assert checked > 100


def test_are_vectors_different_time_matches_reference(reftime):
    rng = random.Random(4)
    ctx = _ctx()
    for trial in range(300):
        v1 = random_time_vector(rng)
        v2 = random_time_vector(rng) if rng.random() < 0.7 else v1
        if (v1 is not None and len(v1) > 2) \
                and v2 is v1 and rng.random() < 0.5:
            v2 = (v1[0], v1[1], list(v1[2]))
        try:
            ref = reftime.areVectorsDifferentTime(v1, v2)
        except Exception:
            continue
        assert are_vectors_different_time(ctx, v1, v2) == ref, (v1, v2)


def test_is_minor_date_matches_reference(reftime):
    rng = random.Random(5)
    for trial in range(200):
        def rd():
            r = rng.random()
            if r < 0.2:
                return None
            m = rng.randrange(0, 10)
            if r < 0.6:
                return (m,)
            return (m, m - rng.randrange(0, 3))
        d1, d2 = rd(), rd()
        for ident in (False, True):
            assert is_minor_date(d1, d2, only_find_identical=ident) \
                == reftime.isMinorDate(d1, d2, onlyFindIdentical=ident), \
                (d1, d2, ident)


def test_read_dates_formats(tmp_path):
    p = tmp_path / "dates.tsv"
    p.write_text("strain\tdate\n"
                 "s1\t2021-03-15\n"
                 "s2\t2021-03\n"
                 "s3\t2021\n"
                 "s4\t15-Mar-2021\n"
                 "s5\tunknown\n"
                 "s6\t2021.21\n")
    dates, min_year, min_day = read_dates(str(p))
    assert dates["s1"] == dates["s4"]          # same day, two formats
    assert dates["s5"] is None
    assert len(dates["s2"]) == 2               # month -> interval range
    assert len(dates["s3"]) == 2               # year -> interval range
    assert min_year == 2021


def test_timetree_end_to_end(tmp_path):
    """Full pipeline with --datesFile: placement with time scoring,
    mutation-rate EM, time LK in _LK.txt.  (No reference oracle: the
    reference's own time path crashes on unguarded -inf unpacks.)"""
    import os
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import run_inference
    dates = os.path.join(os.path.dirname(__file__), "goldens",
                         "dates_mild.tsv")
    if not os.path.isfile(dates):
        pytest.skip("dates fixture missing")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        input=os.path.join(os.path.dirname(__file__), "goldens",
                           "example_sub80.maple"),
        datesFile=dates, intervalLength=30, model="GTR", output=out,
        overwrite=True)
    run_inference(cfg)
    lk = float(open(out + "_LK.txt").read())
    assert lk < -40000 and lk == lk  # finite, includes time term
    assert os.path.isfile(out + "_tree.tree")
