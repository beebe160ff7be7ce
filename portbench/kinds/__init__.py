"""The kinds of cell: each module builds a run of its configurations
(`Cell`), drives the measured window (`run_window`) and computes its
control (`control_numbers`)."""

import numpy as np


def seed_of(seed: int, *path: int) -> int:
    """A 63-bit seed for one part of a run, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
