"""Command-line interface.

Flag-compatible with the reference CLI (MAPLEv0.7.5.4.py:26-128): a user of
``pypy3 MAPLEv0.7.5.4.py --input X --output Y ...`` can invoke
``python -m maple_jax --input X --output Y ...`` with the same flags, plus
the device-path additions (--devicePlacement etc.).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import MapleConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="maple-jax",
        description="Maximum-likelihood phylogenetics for "
                    "pandemic-scale low-divergence datasets (MAPLE-style "
                    "inference on JAX/XLA).")
    defaults = MapleConfig()
    snake_extras = {
        "device_placement": "devicePlacement",
        "device_topology": "deviceTopology",
        "device_warmup": "deviceWarmup",
        "device_batch_size": "deviceBatchSize",
        "use_device_kernels": "useDeviceKernels",
        "device_batch_min": "deviceBatchMin",
        "device_proxy_batch": "deviceProxyBatch",
        "device_seed_topm": "deviceSeedTopm",
        "device_seed_budget": "deviceSeedBudget",
        "entry_budget": "entryBudget",
        "kernel_backend": "kernelBackend",
    }
    for f in dataclasses.fields(MapleConfig):
        flag = "--" + snake_extras.get(f.name, f.name)
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(flag, action="store_true",
                                default=default)
        elif isinstance(default, int):
            parser.add_argument(flag, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)
    parser.add_argument("--aBayesPlus", dest="SPRTA", action="store_true",
                        help="synonym for --SPRTA")
    parser.add_argument("--version", action="store_true")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        from . import __version__
        print(f"maple-jax {__version__}")
        return 0
    kwargs = {}
    rev = {v: k for k, v in {
        "device_placement": "devicePlacement",
        "device_topology": "deviceTopology",
        "device_warmup": "deviceWarmup",
        "device_batch_size": "deviceBatchSize",
        "use_device_kernels": "useDeviceKernels",
        "device_batch_min": "deviceBatchMin",
        "device_proxy_batch": "deviceProxyBatch",
        "device_seed_topm": "deviceSeedTopm",
        "device_seed_budget": "deviceSeedBudget",
        "entry_budget": "entryBudget",
        "kernel_backend": "kernelBackend",
    }.items()}
    field_names = {f.name for f in dataclasses.fields(MapleConfig)}
    for key, value in vars(args).items():
        name = rev.get(key, key)
        if name in field_names:
            kwargs[name] = value
    cfg = MapleConfig(**kwargs)
    from .pipeline import run_inference
    run_inference(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
