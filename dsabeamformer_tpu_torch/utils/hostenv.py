"""Host-environment helpers: the process's resident memory (the
memory-stability metric of the soak runs and the search's host footprint).
"""

from __future__ import annotations

__all__ = ["process_rss_mb"]


def process_rss_mb() -> float:
    """This process's resident set size in MB (VmRSS — includes touched
    shared-memory ring pages, which is what the soak's host-RAM sizing
    claims are about)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0
