"""Shared finding type + helpers for the distlr-lint passes."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint problem.

    ``key`` is the STABLE identity a baseline suppression matches on —
    pass-specific, never containing line numbers (a suppression must
    survive unrelated edits above the finding).  ``where`` carries the
    human-facing ``file:line`` location(s); for cross-file findings
    (wire parity) both sides are listed.
    """

    #: which pass produced it ("wire", "concurrency", "config", "metrics")
    pass_name: str
    #: stable suppression identity, e.g.
    #: "unlocked-write:distlr_tpu_torch/ps/server.py:ServerGroup.ports"
    key: str
    #: human-readable problem statement
    message: str
    #: ("file", line) locations, repo-relative — rendered as file:line
    locations: tuple[tuple[str, int], ...] = ()

    def render(self) -> str:
        locs = " ".join(f"{f}:{ln}" for f, ln in self.locations)
        return f"[{self.pass_name}] {self.key}: {self.message}" + (
            f"  ({locs})" if locs else "")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def rel(path: str) -> str:
    return os.path.relpath(path, repo_root())
