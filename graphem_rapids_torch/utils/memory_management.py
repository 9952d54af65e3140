"""Memory budgets, chunk sizes and memory observation.

Counterpart of ``graphem_rapids_tpu/utils/memory_management.py``. Chunk
sizes come from a device budget: on a CUDA card its total memory
(``torch.cuda.mem_get_info``), on the CPU a 4 GiB working budget, the JAX
package's, so that CPU values equal the JAX function's. Live statistics
serve observation only (the decorator and the context manager).
"""

import functools
import gc
import logging
import time

import torch

logger = logging.getLogger(__name__)

# Working budget of a host without device statistics (bytes).
CPU_BUDGET = 4 * 1024**3
# The JAX package's per-core VMEM budget for its Pallas tile on the TPU;
# it sizes the 'pallas' tile off the card, so that CPU values match.
VMEM_BUDGET = 16 * 1024**2
# Shared memory one block of an H100 can use (bytes): the budget of the
# 'pallas' tile on a CUDA card.
SMEM_PER_BLOCK = 232_448

# Fraction of the budget a single kNN distance block may use.
KNN_BLOCK_FRACTION = 0.25


def _device(device):
    """``torch.device`` for ``device``; None is the current CUDA device when
    there is one, else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def get_device_memory_info(device=None):
    """Live memory of a device: dict with 'bytes_in_use', 'bytes_limit',
    'bytes_free'; all None on the CPU."""
    dev = _device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": None, "bytes_limit": None, "bytes_free": None}
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "bytes_limit": total,
        "bytes_free": free,
    }


def _platform_budget(device=None):
    info = get_device_memory_info(device)
    if info["bytes_limit"]:
        return info["bytes_limit"]
    return CPU_BUDGET


def get_optimal_chunk_size(n_vertices, n_components, strategy="auto",
                           sample_size=1024, device=None, dtype_bytes=4):
    """Ref-tile width of the chunked and 'pallas' kNN, from the budget.

    A distance block is (sample_size x chunk) floats, capped at
    KNN_BLOCK_FRACTION of the budget. The 'pallas' tile is further capped
    by fast memory. On a CUDA card the cap is the kernel's shared-memory
    working set, not the TPU's VMEM: a tile of refs (chunk x n_components
    floats) staged in one block's shared memory (SMEM_PER_BLOCK). The
    kernel of csrc/knn_tiled.cu chooses its own blocking and reads the refs
    through L1, so there the value is informational. Elsewhere the cap is
    the JAX package's: the (sample x tile) block in VMEM, double-buffered.
    The tile is then clamped to [1024, 65536] and a multiple of 128.
    """
    budget = _platform_budget(device)
    max_block = int(budget * KNN_BLOCK_FRACTION)
    chunk = max_block // max(sample_size * dtype_bytes, 1)

    if strategy == "pallas":
        if _device(device).type == "cuda":
            cap = SMEM_PER_BLOCK // max(n_components * dtype_bytes, 1)
        else:
            cap = VMEM_BUDGET // max(sample_size * dtype_bytes * 2, 1)
        chunk = min(chunk, cap)

    chunk = max(1024, min(chunk, 65536))
    return (chunk // 128) * 128


def cleanup_device_memory():
    """Collect garbage and return the CUDA caching allocator's free blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def monitor_memory_usage(func):
    """Decorator logging the device-memory delta around a call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        before = get_device_memory_info()["bytes_in_use"]
        start = time.perf_counter()
        result = func(*args, **kwargs)
        elapsed = time.perf_counter() - start
        after = get_device_memory_info()["bytes_in_use"]
        if before is not None and after is not None:
            logger.debug(
                "%s: %.1f MiB -> %.1f MiB (delta %+.1f MiB) in %.3fs",
                func.__name__, before / 1024**2, after / 1024**2,
                (after - before) / 1024**2, elapsed,
            )
        return result

    return wrapper


class MemoryManager:
    """Context manager recording device memory before and after."""

    def __init__(self, cleanup_on_exit=False, device=None):
        self.cleanup_on_exit = cleanup_on_exit
        self.device = device
        self.before = None
        self.after = None

    def __enter__(self):
        self.before = get_device_memory_info(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.after = get_device_memory_info(self.device)
        if self.cleanup_on_exit:
            cleanup_device_memory()
        if (
            self.before["bytes_in_use"] is not None
            and self.after["bytes_in_use"] is not None
        ):
            logger.debug(
                "MemoryManager: %+.1f MiB",
                (self.after["bytes_in_use"] - self.before["bytes_in_use"])
                / 1024**2,
            )
        return False


def adaptive_batch_size(n_items, item_bytes, device=None, fraction=0.3,
                        floor=1024, cap=1 << 20):
    """Largest batch of ``item_bytes``-sized items within a budget fraction."""
    budget = _platform_budget(device)
    batch = int(budget * fraction) // max(item_bytes, 1)
    return max(floor, min(batch, cap, n_items))


def check_memory_requirements(n_vertices, n_components, strategy="auto",
                              sample_size=1024, device=None):
    """Estimate the footprint and recommend a tier.

    Returns dict with required_gb, available_gb, sufficient, recommendation
    in {'<strategy>', '<strategy>_chunked', 'sharded'}.
    """
    # positions + forces + edge gathers (~5 position-sized buffers) plus one
    # distance block
    pos_bytes = n_vertices * n_components * 4
    avg_degree_guess = 8
    edge_bytes = n_vertices * avg_degree_guess * (2 * 4 + n_components * 4)
    block_bytes = sample_size * get_optimal_chunk_size(
        n_vertices, n_components, strategy, sample_size, device
    ) * 4
    required = 5 * pos_bytes + edge_bytes + block_bytes

    budget = _platform_budget(device)
    sufficient = required < budget * 0.8
    if sufficient:
        recommendation = strategy if strategy != "auto" else "single_chip"
    elif required < budget:
        recommendation = f"{strategy}_chunked"
    else:
        recommendation = "sharded"
    return {
        "required_gb": required / 1024**3,
        "available_gb": budget / 1024**3,
        "sufficient": sufficient,
        "recommendation": recommendation,
    }
