"""Typed reject reasons: the serving stack's public refusal vocabulary.

A pure copy of ``repro/serving/errors.py`` (the same names, wire values
and HTTP statuses), kept in the port so that it imports nothing of the
JAX package.  Every way the scheduler can refuse a request is a
:class:`RejectCode` raised as a :class:`RequestError`, which subclasses
``ValueError``; callers switch on ``err.code``.

Client-side codes (4xx) mean resubmitting the same request cannot
succeed against this serving configuration; availability codes (5xx /
429) mean the request was valid but was refused now.
"""
from __future__ import annotations

import enum


class RejectCode(enum.Enum):
    """Stable wire identifiers for every refusal the serving stack emits."""

    # --- client errors (4xx): the request itself can never be served
    BAD_REQUEST = "bad-request"                  # malformed field/body
    BAD_STEPS = "bad-steps"                      # S outside [1, T]
    STOCHASTIC_UNSUPPORTED = "stochastic-unsupported"  # eta>0 on det pool
    SCHEDULE_MISMATCH = "schedule-mismatch"      # plan built on another T
    CLIP_MISMATCH = "clip-mismatch"              # plan clip != pool clip
    ORDER_UNSUPPORTED = "order-unsupported"      # plan order > max_order
    AUTO_PLAN_CONFLICT = "auto-plan-conflict"    # auto_plan + explicit plan
    NO_PLAN_BANK = "no-plan-bank"                # auto_plan, bankless pool
    BANK_INCOMPATIBLE = "bank-incompatible"      # bank has no servable row
    UNKNOWN_MODEL = "unknown-model"              # no resident checkpoint
    # --- availability (429/5xx): valid request, refused by current load
    QUEUE_FULL = "queue-full"                    # admission depth bound
    SHED_OVERLOAD = "shed-overload"              # depth shed (overload)
    SHED_INFEASIBLE = "shed-infeasible"          # deadline can't be met
    EXPIRED = "expired"                          # deadline passed in queue
    MODEL_UNAVAILABLE = "model-unavailable"      # every eligible pool is
    #                                              quarantined/stopped
    # --- server faults (5xx): the system failed the request
    NONFINITE_SAMPLE = "nonfinite-sample"        # NaN/Inf terminal result
    CANCELLED = "cancelled"                      # client closed the stream

    @property
    def http_status(self) -> int:
        return _HTTP_STATUS[self]


_HTTP_STATUS = {
    RejectCode.BAD_REQUEST: 400,
    RejectCode.BAD_STEPS: 400,
    RejectCode.STOCHASTIC_UNSUPPORTED: 400,
    RejectCode.SCHEDULE_MISMATCH: 400,
    RejectCode.CLIP_MISMATCH: 400,
    RejectCode.ORDER_UNSUPPORTED: 400,
    RejectCode.AUTO_PLAN_CONFLICT: 400,
    RejectCode.NO_PLAN_BANK: 400,
    RejectCode.BANK_INCOMPATIBLE: 400,
    RejectCode.UNKNOWN_MODEL: 404,
    RejectCode.QUEUE_FULL: 429,
    RejectCode.SHED_OVERLOAD: 503,
    RejectCode.SHED_INFEASIBLE: 503,
    RejectCode.EXPIRED: 504,
    RejectCode.MODEL_UNAVAILABLE: 503,
    RejectCode.NONFINITE_SAMPLE: 500,
    RejectCode.CANCELLED: 499,       # nginx convention: client closed
}


class RequestError(ValueError):
    """A typed request refusal: ``.code`` is the RejectCode, ``.status``
    the HTTP status a gateway maps it to. str() is the human message.

    ``retry_after_s`` (availability refusals only) is the gateway's
    backlog-derived retry hint — the HTTP layer surfaces it as a
    ``Retry-After`` header; None means no estimate was attached.
    """

    def __init__(self, code: RejectCode, message: str,
                 retry_after_s: "int | None" = None):
        super().__init__(message)
        self.code = code
        self.retry_after_s = retry_after_s

    @property
    def status(self) -> int:
        return self.code.http_status

    def payload(self) -> dict:
        """The structured error body a gateway returns."""
        out = {"error": self.code.value, "message": str(self)}
        if self.retry_after_s is not None:
            out["retry_after_s"] = self.retry_after_s
        return out
