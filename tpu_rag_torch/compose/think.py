"""ThinkFolder: split <think>...</think> reasoning out of a token stream.

Same contract as the reference's incremental state machine (reference
api/routes/chat.py:29-92): feed() returns {"type": "reasoning"|"text",
"data": ...} events; tags may arrive split across token boundaries, so the
longest prefix of a tag found at the end of the buffer is withheld until the
next token resolves it; flush() emits the tail.
"""

from __future__ import annotations

START_TAG = "<think>"
END_TAG = "</think>"


def _partial_tag_suffix(buf: str, tag: str) -> int:
    """Length of the longest strict prefix of `tag` that ends `buf` (0 if none)."""
    max_len = min(len(tag) - 1, len(buf))
    for n in range(max_len, 0, -1):
        if buf.endswith(tag[:n]):
            return n
    return 0


class ThinkFolder:
    def __init__(self) -> None:
        self._reasoning = False
        self._buf = ""

    def feed(self, token: str) -> list[dict]:
        self._buf += token
        events: list[dict] = []
        while True:
            tag = END_TAG if self._reasoning else START_TAG
            kind = "reasoning" if self._reasoning else "text"
            pos = self._buf.find(tag)
            if pos == -1:
                held = _partial_tag_suffix(self._buf, tag)
                emit = self._buf[: len(self._buf) - held]
                if emit:
                    events.append({"type": kind, "data": emit})
                self._buf = self._buf[len(self._buf) - held:]
                return events
            if pos > 0:
                events.append({"type": kind, "data": self._buf[:pos]})
            self._buf = self._buf[pos + len(tag):]
            self._reasoning = not self._reasoning

    def flush(self) -> list[dict]:
        events: list[dict] = []
        if self._buf:
            kind = "reasoning" if self._reasoning else "text"
            events.append({"type": kind, "data": self._buf})
            self._buf = ""
        return events
