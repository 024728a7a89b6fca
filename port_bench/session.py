"""What one run of one cell gathers: the drivers fill it, the metric
readers and the result line read it."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Optional

from port_bench.manifest import Cell


@dataclass
class Session:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    process_start: float
    control: str = "none"       # "reduced": the comparison's control
    fault: str = "none"         # a fault planted under the timed path
    sizes: dict = field(default_factory=dict)   # test-size overrides:
    traffic_sizes: dict = field(default_factory=dict)   # of both files
    # filled by the driver
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)
    stage_ms: dict = field(default_factory=dict)
    resample_inputs: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    episodes: list = field(default_factory=list)
    trace_data: Optional[dict] = None
    compared: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    captures_in_window: int = 0
    first_run: bool = False
    marks: list = field(default_factory=list)

    @property
    def config(self) -> dict:
        return {**self.cell.config, **self.sizes}

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.traffic_sizes}

    def mark(self, phase: str) -> None:
        """Note the end of a phase of set-up (seconds since the process
        started)."""
        import time

        self.marks.append((phase, time.time() - self.process_start))

    def card_state(self, when: str) -> None:
        """Say the card's SM clock and temperature now (a ``nvidia-smi``
        query: call it outside the measured window)."""
        if getattr(self.device, "type", "cpu") == "cuda":
            from port_bench import card

            self.say(f"at the window's {when}: {card.clocks()}")

    def say(self, line: str) -> None:
        """An earlier line of the run, on standard error."""
        print(line, file=sys.stderr, flush=True)
