"""ANSI-styled terminal messages and section headers.

Parity target: fl_tissue_model_tools/colored_messages.py:8-28 and the section
header/footer helpers in script_util.py:17-37. The escape sequences and tag
texts are an output CONTRACT (scripts and tests match on the exact bytes);
they are built here from the 256-color palette indices rather than spelled
out per attribute.
"""

from __future__ import annotations

import shutil

_BOLD = "\x1b[1m"
_RESET = "\x1b[0m"


def _color(palette_index: int) -> str:
    """Bold 256-color foreground prefix (xterm palette)."""
    return f"\x1b[38;5;{palette_index}m{_BOLD}"


def _tag(text: str, color: str) -> str:
    return f"{color}[{text}]{_RESET}"


class SFM:
    """Colored terminal message tags (same tag vocabulary and byte-exact
    escape sequences as the reference's SFM)."""

    red = _color(1)
    green = _color(2)
    yellow = _color(3)
    blue = _color(4)
    purple = _color(5)
    cyan = _color(6)
    bold = _BOLD
    reset = _RESET
    success = _tag("SUCCESS", green)
    failure = _tag("FAILURE", red)
    warning = _tag("WARNING", yellow)
    info = _tag("INFO", blue)
    all_succeeded = _tag("ALL SUCCEEDED", green)
    failures_present = _tag("FAILURES PRESENT", red)

    @classmethod
    def highlight(cls, text: str) -> str:
        return f"{cls.purple}{text}{cls.reset}"


def _term_width(default: int = 80) -> int:
    try:
        return shutil.get_terminal_size().columns
    except Exception:
        return default


def section_header(title: str) -> None:
    width = max(len(title) + 4, min(_term_width(), 80))
    print("", flush=True)
    print("=" * width, flush=True)
    print(f"| {title}", flush=True)
    print("=" * width, flush=True)


def section_footer() -> None:
    print("=" * min(_term_width(), 80), flush=True)
    print("", flush=True)


END_SEPARATOR = "=" * 80
