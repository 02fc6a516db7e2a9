"""Structured logging (SURVEY.md §5.5): plain text or JSON-lines."""

from __future__ import annotations

import json
import logging
import sys
import time


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        d = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if hasattr(record, "metrics"):
            d["metrics"] = record.metrics
        return json.dumps(d)


def setup_logging(json_lines: bool = False, verbose: bool = False) -> None:
    h = logging.StreamHandler(sys.stderr)
    if json_lines:
        h.setFormatter(JsonFormatter())
    else:
        h.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [h]
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
