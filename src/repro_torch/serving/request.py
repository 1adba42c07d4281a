"""Request model: the serverless-function-invocation analogue.

A request declares its token budget up front (``max_tokens`` — the paper's
user-declared function memory limit); the budget sizes its HotMem partition.
``FunctionProfile`` mirrors the paper's Table 1 workloads (Cnn / Bert / BFS /
HTML): different budgets and compute weights driven by separate traces.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class State(enum.Enum):
    PENDING = "pending"      # in admission waitqueue
    PREFILL = "prefill"
    RUNNING = "running"      # decoding
    DONE = "done"
    KILLED = "killed"        # exceeded declared budget (OOM-kill analogue)


@dataclasses.dataclass
class FunctionProfile:
    """Paper Table 1 analogue: per-function resource declaration."""
    name: str
    prompt_tokens: int
    decode_tokens: int        # typical completion length
    max_tokens: int           # declared budget (partition size driver)
    weight: float = 1.0       # relative invocation rate
    # multi-tenant / SLO-tier metadata (empty = single-tenant default /
    # "standard" tier).  ``slo_tier`` is one of "tight" (latency-critical:
    # spend warm/snapshot capacity here), "standard", "batch" (throughput
    # traffic: routed cold, never spends cached warm state).
    tenant: str = ""
    slo_tier: str = "standard"


# the four paper workloads, scaled to token budgets
PROFILES = {
    "cnn": FunctionProfile("cnn", prompt_tokens=24, decode_tokens=24,
                           max_tokens=64),
    "bert": FunctionProfile("bert", prompt_tokens=48, decode_tokens=40,
                            max_tokens=96),
    "bfs": FunctionProfile("bfs", prompt_tokens=16, decode_tokens=32,
                           max_tokens=64),
    "html": FunctionProfile("html", prompt_tokens=8, decode_tokens=16,
                            max_tokens=32),
}


@dataclasses.dataclass
class Request:
    rid: str
    profile: FunctionProfile
    submit_s: float
    prompt: Optional[list[int]] = None
    state: State = State.PENDING
    partition: Optional[int] = None      # arena row once admitted
    position: int = 0                    # decode cursor (global position)
    target_tokens: int = 0               # when to stop
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    # per-request overrides; empty = inherit from the profile
    tenant: str = ""
    slo_tier: str = ""

    @property
    def latency(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.submit_s


def tenant_of(req: Request) -> str:
    """Effective tenant: request override > profile > '' (single-tenant)."""
    return req.tenant or req.profile.tenant


def slo_tier_of(req: Request) -> str:
    """Effective SLO tier: request override > profile > 'standard'."""
    return req.slo_tier or req.profile.slo_tier or "standard"
