"""mfu.eval: the whole step's share of the card's peak FLOP/s, %."""

from benchmark.readers import mfu as read  # noqa: F401
