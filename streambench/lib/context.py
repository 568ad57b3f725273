"""What a metric reader sees of a run."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from streambench.lib.playout import Playout
from streambench.lib.serve import RunRecord, StepRecord


@dataclasses.dataclass
class Ctx:
    cell: str
    cfg: Dict                      # the configuration file
    rec: RunRecord
    play: Playout
    summary: Dict[str, float]      # playout.summary
    trace: Optional[Dict]          # trace.DeviceTrace.reduce, traced runs

    def window_steps(self) -> List[StepRecord]:
        """Launched steps that ended inside the window."""
        t0, win = self.rec.t0, self.rec.window
        return [s for s in self.rec.steps
                if s.launched and win.holds(s.end - t0)]
