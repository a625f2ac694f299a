"""The benchmark's own tests: CPU tests of the harness at small sizes, and
tests marked `cuda` that skip without a card (decided inside each test).

    python -m pytest mpcbench/tests -q              # here, on the CPU
    python -m pytest mpcbench/tests -q -m cuda      # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
