"""Vision ops: pyramids, filters, Farneback and Lucas-Kanade flow, warps
and corner seeding, in plain JAX compiled by XLA."""
from . import (color, farneback, features, filters, lk, pyramid, segment,  # noqa: F401
               warp)
