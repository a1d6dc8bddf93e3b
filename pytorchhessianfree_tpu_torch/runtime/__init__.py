"""Native host runtime: the C++ prefetching batch loader and the device
prefetcher (port of :mod:`pytorchhessianfree_tpu.runtime`)."""

from .loader import PrefetchLoader
from .prefetch import DevicePrefetcher

__all__ = ["PrefetchLoader", "DevicePrefetcher"]
