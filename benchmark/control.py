#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: see
``fvbench/control.py``."""
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(1, os.path.dirname(_HERE))

if __name__ == "__main__":
    from fvbench import control
    sys.exit(control.main())
