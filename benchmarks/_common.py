"""Shared benchmark plumbing: repo root on sys.path and the persistent
compile cache."""

import os
import sys

# allow running from anywhere: repo root on sys.path
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def setup_cache():
    from tci_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
