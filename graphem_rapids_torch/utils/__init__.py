"""Utilities: strategy selection, memory budgets, profiling, tracing."""

from .backend_selection import (
    BackendConfig,
    check_cuda_availability,
    estimate_memory_usage,
    get_data_complexity_score,
    get_default_config,
    get_optimal_backend,
    log_backend_selection,
)
from .memory_management import (
    MemoryManager,
    adaptive_batch_size,
    check_memory_requirements,
    cleanup_device_memory,
    get_device_memory_info,
    get_optimal_chunk_size,
    monitor_memory_usage,
)
from .profiling import time_fn, trace

__all__ = [
    "BackendConfig",
    "check_cuda_availability",
    "get_data_complexity_score",
    "get_default_config",
    "get_optimal_backend",
    "estimate_memory_usage",
    "log_backend_selection",
    "MemoryManager",
    "adaptive_batch_size",
    "check_memory_requirements",
    "cleanup_device_memory",
    "get_device_memory_info",
    "get_optimal_chunk_size",
    "monitor_memory_usage",
    "time_fn",
    "trace",
]
