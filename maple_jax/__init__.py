"""maple-jax: a maximum-likelihood phylogenetics framework on JAX.

A from-scratch re-design of the capabilities of MAPLE (De Maio et al.,
"MAPLE: MAximum Parsimonious Likelihood Estimation" — reference implementation
``MAPLEv0.7.5.4.py``) for pandemic-scale, low-divergence datasets, built
on JAX/XLA:

- sparse "genome list" partial-likelihood representation (run-length diffs
  from a local reference) with exact host-side semantics in
  :mod:`maple_jax.core`,
- batched device kernels over padded entry tensors in :mod:`maple_jax.ops`
  (candidate-placement batching is the device compute axis),
- tree runtime with incremental dirty-propagation in
  :mod:`maple_jax.runtime`,
- placement / SPR / root search in :mod:`maple_jax.search`,
- multi-host scale-out over ``jax.sharding.Mesh`` in
  :mod:`maple_jax.parallel`,
- MAPLE/newick/nexus I-O in :mod:`maple_jax.io`.
"""

__version__ = "0.1.0"
