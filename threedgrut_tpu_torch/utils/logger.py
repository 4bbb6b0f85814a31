"""Rich console logger (threedgrut/utils/logger.py:49 equivalent; copied
from threedgrut_tpu/utils/logger.py). Plain logging where rich does not
import (``_HAVE_RICH``).

One departure: the progress bar's it/s column shows blanks until rich
has measured a speed, where JAX's formats ``task.speed`` (None at
first) with ``:>6.1f`` and raises TypeError on its first refresh.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager

try:
    from rich.console import Console
    from rich.logging import RichHandler
    from rich.progress import (BarColumn, Progress, ProgressColumn,
                               TaskProgressColumn, TextColumn,
                               TimeRemainingColumn)
    from rich.table import Table
    from rich.text import Text
    _HAVE_RICH = True
except ImportError:  # pragma: no cover
    _HAVE_RICH = False


def _speed_text(speed) -> str:
    """The it/s column's text: blanks until a speed is measured."""
    return " " * 6 + " it/s" if speed is None else f"{speed:>6.1f} it/s"


if _HAVE_RICH:
    class _SpeedColumn(ProgressColumn):
        def render(self, task):
            return Text(_speed_text(task.speed))


class TrainLogger:
    """Console logging + progress bars + final stats tables."""

    def __init__(self, name: str = "threedgrut_tpu_torch", level=logging.INFO):
        self._logger = logging.getLogger(name)
        if not self._logger.handlers:
            if _HAVE_RICH:
                handler = RichHandler(rich_tracebacks=True, show_path=False)
            else:
                handler = logging.StreamHandler()
            self._logger.addHandler(handler)
        self._logger.setLevel(level)
        self.console = Console() if _HAVE_RICH else None

    def info(self, msg, *a):
        self._logger.info(msg, *a)

    def warning(self, msg, *a):
        self._logger.warning(msg, *a)

    def error(self, msg, *a):
        self._logger.error(msg, *a)

    @contextmanager
    def progress(self, description: str, total: int):
        """Progress bar with an it/s column (logger.py:49-162)."""
        if not _HAVE_RICH:
            yield lambda n=1: None
            return
        with Progress(TextColumn("[progress.description]{task.description}"),
                      BarColumn(), TaskProgressColumn(), _SpeedColumn(),
                      TimeRemainingColumn()) as progress:
            task = progress.add_task(description, total=total)
            yield lambda n=1: progress.advance(task, n)

    def table(self, title: str, rows: dict):
        if not _HAVE_RICH:
            for k, v in rows.items():
                self.info(f"{title} | {k}: {v}")
            return
        t = Table(title=title)
        t.add_column("metric")
        t.add_column("value")
        for k, v in rows.items():
            t.add_row(str(k), f"{v:.4f}" if isinstance(v, float) else str(v))
        self.console.print(t)

    def rule(self, title: str = ""):
        if self.console:
            self.console.rule(title)


logger = TrainLogger()
