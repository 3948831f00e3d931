#!/usr/bin/env python3
"""Run phases of chip_smoke.py alone on one Hopper card.

    python3 tools/run_phase.py benchmarking [mesh ...]

Builds the port's kernels (at first use), then calls
`chip_smoke.phase_<name>(torch.device("cuda", 0), label)` for each name in
turn: the phases that take the device and the card's label alone
(benchmarking, mesh, mesh_train, mesh_moe, fwd_tiles, bwd_tiles, ...).
Prints each phase's seconds and the card's name and power limit; exits
non-zero if a phase fails or there is no card.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(names) -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not names:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the phases run on a Hopper GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flashattention_kernel_project_tpu_torch.ops import _build
    from flashattention_kernel_project_tpu_torch.utils import platform

    platform.require_hopper()
    label = platform.card_label()
    cs.log(label)
    clock = cs.PhaseClock()
    with clock("build"):
        _build.library()
    for name in names:
        with clock(name):
            getattr(cs, f"phase_{name}")(torch.device("cuda", 0), label)
    cs.log(clock.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
