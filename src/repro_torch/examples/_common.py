"""What the examples share: the ``--chip`` flag, the line that names the
chip model every derived number is modeled on, and a printer that keeps
what it printed (``main`` returns it)."""
from __future__ import annotations

import argparse
from typing import List

from ..core.power_model import CHIPS

#: lines carrying host seconds end so; nothing else in an example differs
#: from run to run on the same inputs
HOST_MARK = "on this host"


def add_chip_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--chip", default="h100", choices=sorted(CHIPS),
                    help="chip model the plans and books are modeled on")


class Printer:
    """``print`` that also keeps each line in ``lines``."""

    def __init__(self) -> None:
        self.lines: List[str] = []

    def __call__(self, line: str = "") -> None:
        print(line)
        self.lines.extend(line.split("\n"))

    def chip(self, chip: str) -> None:
        """The first line of every example: which chip model its times,
        energies and watts come from."""
        self(f"chip model: {chip} (every time, energy and power derived "
             f"from it below is modeled, not measured)")
