"""Which of the program's device operations belongs to which layer, by the
kernel names of ``graphem_rapids_torch/csrc/``."""

K1 = ("binfold_kernel",)
ACCUMULATOR = ("static_sum_kernel", "cluster_sum_kernel",
               "segment_sum_kernel", "sort_tiles_kernel")
COPIES = ("Memcpy", "Memset")


def is_k1(name):
    return any(k in name for k in K1)


def is_accumulator(name):
    return any(k in name for k in ACCUMULATOR)


def is_copy(name):
    return name.startswith(COPIES)


def is_step_pass(name):
    return not (is_k1(name) or is_accumulator(name) or is_copy(name))


def iterations(run):
    """Replayed iterations in the traced window."""
    return run.window["calls"] * run.facts["iterations_per_call"]
