"""Share of the traced window in which the card ran nothing, in %; serves every `idle_share.<cells>` name."""

from perfbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
