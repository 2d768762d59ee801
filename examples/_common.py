"""Shared example setup: make the repo importable when the package is not
installed. Examples run on JAX's default backend; set JAX_PLATFORMS=cpu to
run them on the host CPU."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
