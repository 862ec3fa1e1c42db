"""Security- and fault-plane failures (a copy of ``repro.security.errors``).

``SecurityError`` subclasses ``ConnectionAbortedError`` so existing
callers that treat a QBER abort as a dropped link keep working, while new
code can catch the precise type and read which edge(s) failed. Raised —
never ``assert``-ed, which would vanish under ``python -O`` — for both
QBER aborts at key establishment and MAC verification failures.

The ``FaultError`` family covers the *injected* LEO availability faults
(link flaps, satellite crashes, payload corruption, retry exhaustion)
compiled into the :class:`repro_torch.core.plan.FaultSchedule`. They
share the ``ConnectionAbortedError`` base for the same drop-in reason,
and carry
``sites`` — (round, edge-or-sat) tuples — instead of bare edges, because
the same fault site must be reported identically by the per-client
oracle and the batched executor. Under ``fl.on_fault='drop'`` (default)
the engines degrade per mode instead of raising; ``'raise'`` surfaces
the first fault of a round as the matching subclass.
"""
from __future__ import annotations


class SecurityError(ConnectionAbortedError):
    """A secure exchange failed; ``edges`` names the offending edge(s)."""

    def __init__(self, message: str, edges=()):
        super().__init__(message)
        self.edges = tuple(edges)


class FaultError(ConnectionAbortedError):
    """An injected availability fault; ``sites`` names (round, where)."""

    def __init__(self, message: str, sites=()):
        super().__init__(message)
        self.sites = tuple(sites)


class LinkFlapError(FaultError):
    """An ISL/feeder link dropped before the payload moved."""


class SatCrashError(FaultError):
    """A satellite's payload computer was down for the round."""


class CorruptionError(FaultError):
    """A payload arrived corrupted — the receiver's MAC rejected it."""


class RetryExhaustedError(FaultError):
    """An async update was lost after ``max_retries`` retransmissions."""
