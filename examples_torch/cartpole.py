"""Cartpole swing-up with PDDP (learned BNN dynamics; port of
``examples/cartpole.py``): ``experiment.py``'s loop on the cartpole.

Usage:
    python examples_torch/cartpole.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _root not in _sys.path:
    _sys.path.insert(0, _root)

from examples_torch import experiment


def main(argv=None):
    return experiment.main(argv, problem="cartpole")


if __name__ == "__main__":
    main()
