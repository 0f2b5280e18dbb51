"""Pure scheduling decisions of the serving engine.

The port's share of ``analytics_zoo_tpu/serving/policy.py``: only
:func:`pick_victim`, the preemption choice the paged engine makes when
its block pool runs dry.  The rest of the module (chunk planning, QoS,
brownout, pool resizing) comes with the engine modes that use it.
"""

from __future__ import annotations

from typing import Iterable, Tuple


def pick_victim(rows: Iterable[Tuple[int, str, int]]) -> int:
    """Pool-dry preemption choice over resident rows, each a
    ``(slot, state, admit_seq)`` triple.  PREFILLING rows first: they
    lost no emitted tokens and requeue cheaply; among candidates,
    always the LATEST admission (earliest admissions keep strict
    forward progress, so repeated preemption terminates)."""
    rows = list(rows)
    pre = [r for r in rows if r[1] == "PREFILLING"]
    return max(pre or rows, key=lambda r: r[2])[0]
