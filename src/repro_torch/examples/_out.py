"""What an example prints, kept: each example's ``main`` returns its lines
beside its results."""
from __future__ import annotations


class Printer:
    """``say(line)`` prints the line and keeps it in ``lines``."""

    def __init__(self):
        self.lines: list[str] = []

    def __call__(self, line: str = ""):
        print(line, flush=True)
        self.lines.append(line)
