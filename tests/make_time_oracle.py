#!/usr/bin/env python3
"""Build the minimally-patched reference copy used as the TIME-TREE oracle.

The reference's --datesFile path crashes on every tested input before
completing a single run (verified each round; see
maple_jax/models/timetree.py module docstring), so end-to-end time-tree
goldens were previously self-pins.  This script materializes a patched
COPY of /root/reference/MAPLEv0.7.5.4.py with the five minimal guards
that make the author's own error-handling reachable — it changes no
formula, threshold, or search decision:

1. ``mergeVectorsTime(returnLK=True)`` on an incompatible merge returns a
   bare ``float("-inf")`` (reference :711-712), but every caller unpacks
   two values and then checks ``isinstance(x, int)`` to route into
   ``resolveTimeInconsistency`` (e.g. :5544, :8649, :1461) — the bare
   float crashes the unpack and makes the resolver unreachable.  Patched
   to return ``(marker_int, float("-inf"))``, which is exactly what the
   callers' guards expect.
2. ``passedVect1`` in the isUpDown branch of ``mergeVectorsTime`` has no
   int guard at all (reference :717; its twin ``passedVect2`` at :709 is
   guarded) — an incompatible upper operand crashes at ``passedVect1[1]``.
   Patched with the same guard/return as passedVect2.
3. Both ``getPartialVecTime`` calls in the non-isUpDown branch
   (reference :726-727) are unguarded; same patch.
4. The ``newMidVectorTime`` guard in findBestParentForNewSample
   (reference :8136-8139) adds ``-inf`` to the score but FALLS THROUGH
   to ``appendProbNodeTime(newMidVectorTime, ...)`` with the int —
   missing ``else``.  Patched to skip the two uses when invalid.
5. Same fall-through for ``altNewMidVectorTime`` at :8165-8168.

These are the same semantics maple_jax/models/timetree.py implements
natively (merge_vectors_time guards all four operand failures and
returns the (marker, -inf) pair), so the patched reference is a valid
independent oracle for this framework's time-tree runs.

Usage:  python tests/make_time_oracle.py [--out PATH]
prints the patched file path (default /tmp/refpatch/MAPLE_timefix.py).
"""
import argparse
import os

REFERENCE = "/root/reference/MAPLEv0.7.5.4.py"


def build_patched_source() -> str:
    src = open(REFERENCE).read()

    # -- fix 1: keep the int marker on returnLK failure ------------------
    old1 = ('\t\t\t\tprint("mergeVectorsTime returning "+str(passedVect2))\n'
            "\t\t\t\tif returnLK:\n"
            '\t\t\t\t\treturn float("-inf")\n'
            "\t\t\t\telse:\n"
            "\t\t\t\t\treturn passedVect2")
    new1 = old1.replace('return float("-inf")',
                        'return passedVect2, float("-inf")')
    assert src.count(old1) == 1, "fix1 anchor not found"
    src = src.replace(old1, new1)

    # -- fix 2: guard passedVect1 in the isUpDown branch ------------------
    old2 = ("\t\t\tpassedVect1=getPartialVecTime(probVect1, mutRate, bLen1,"
            " otherMinT=None, otherMaxT=maxT2, upNode=True, tryMin=tryMin)\n")
    guard = ("\t\t\tif isinstance(passedVect1, int):\n"
             '\t\t\t\tprint("mergeVectorsTime returning "'
             "+str(passedVect1))\n"
             "\t\t\t\tif returnLK:\n"
             '\t\t\t\t\treturn passedVect1, float("-inf")\n'
             "\t\t\t\telse:\n"
             "\t\t\t\t\treturn passedVect1\n")
    assert src.count(old2) == 1, "fix2 anchor not found"
    src = src.replace(old2, old2 + guard)

    # -- fix 3: guard both operands in the non-isUpDown branch -----------
    old3 = ("\t\t\tpassedVect2=getPartialVecTime(probVect2, mutRate, bLen2,"
            " otherMinT=None, otherMaxT=maxT1, upNode=False,"
            " tryMin=tryMin)\n"
            "\t\t\tpassedVect1=getPartialVecTime(probVect1, mutRate, bLen1,"
            " otherMinT=None, otherMaxT=maxT2, upNode=False,"
            " tryMin=tryMin)\n")
    guard2 = ("\t\t\tif isinstance(passedVect2, int):\n"
              '\t\t\t\tprint("mergeVectorsTime returning "'
              "+str(passedVect2))\n"
              "\t\t\t\tif returnLK:\n"
              '\t\t\t\t\treturn passedVect2, float("-inf")\n'
              "\t\t\t\telse:\n"
              "\t\t\t\t\treturn passedVect2\n")
    guard1 = ("\t\t\tif isinstance(passedVect1, int):\n"
              '\t\t\t\tprint("mergeVectorsTime returning "'
              "+str(passedVect1))\n"
              "\t\t\t\tif returnLK:\n"
              '\t\t\t\t\treturn passedVect1, float("-inf")\n'
              "\t\t\t\telse:\n"
              "\t\t\t\t\treturn passedVect1\n")
    assert src.count(old3) == 1, "fix3 anchor not found"
    lines3 = old3.splitlines(keepends=True)
    src = src.replace(old3, lines3[0] + guard2 + lines3[1] + guard1)

    # -- fixes 4+5: missing else on the -inf fall-through guards ---------
    for depth, var, cost in ((5, "newMidVectorTime", "appendingCost"),
                             (7, "altNewMidVectorTime", "altAppendingCost")):
        t = "\t" * depth
        old = (f"{t}if isinstance({var}, int):\n"
               f'{t}\t{cost}+=float("-inf")\n'
               f"{t}{cost}+=appendProbNodeTime({var},diffsTime,mutRate,"
               f"bestAppendingLength)\n"
               f"{t}{cost}+={var}Cost\n")
        new = (f"{t}if isinstance({var}, int):\n"
               f'{t}\t{cost}+=float("-inf")\n'
               f"{t}else:\n"
               f"{t}\t{cost}+=appendProbNodeTime({var},diffsTime,mutRate,"
               f"bestAppendingLength)\n"
               f"{t}\t{cost}+={var}Cost\n")
        assert src.count(old) == 1, f"fix anchor for {var} not found"
        src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/refpatch/MAPLE_timefix.py")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(build_patched_source())
    print(args.out)


if __name__ == "__main__":
    main()
