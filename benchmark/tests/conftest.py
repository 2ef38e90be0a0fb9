"""The benchmark's CPU tests: run them with `python -m pytest benchmark/tests`."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
