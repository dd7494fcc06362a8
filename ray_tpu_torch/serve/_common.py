"""Shared Serve types the LLM engine uses: the typed load-shed error and
the HTTP request envelope (copies of ``ray_tpu/serve/_common.py``'s, so the
port needs nothing of the JAX package)."""

from __future__ import annotations

import json as _json
from dataclasses import dataclass
from typing import Any


class OverloadedError(Exception):
    """Typed load-shed: admission control rejected the request before it
    could wedge a replica (bounded queue / KV budget exhausted). The marker
    token survives cross-process exception stringifying so a proxy can
    classify a re-raised copy too."""

    MARKER = "SERVE_OVERLOADED"

    def __init__(self, detail: str = ""):
        super().__init__(f"{self.MARKER}: {detail}" if detail
                         else self.MARKER)


def is_overloaded_error(exc: BaseException) -> bool:
    return isinstance(exc, OverloadedError) \
        or OverloadedError.MARKER in f"{type(exc).__name__}{exc}"


@dataclass
class Request:
    """HTTP request envelope an ingress receives; the engine reads only
    its JSON body."""

    body: bytes = b""

    def json(self) -> Any:
        return _json.loads(self.body or b"null")
