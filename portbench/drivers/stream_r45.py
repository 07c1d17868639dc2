"""The stream driver (`drivers/stream.py`) for the rate-4/5 TM code TM5120.

`find_cell` resolves a code's reference only through `reference.codes.CODES`,
which holds the codes of `reference/tables.py`; TM5120's frozen tables live
in `reference/tm_r45.py`, whose import adds them there. This module imports
it for that and runs the stream driver unchanged.
"""

from ..reference import tm_r45  # noqa: F401  (registers TM5120 in reference.codes.CODES)
from .stream import run

__all__ = ["run"]
