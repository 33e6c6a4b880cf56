"""Sectioned text and HTML reprs.

Copy of the JAX package's ``_repr.py``, plus ``write_sections`` (the
``describe`` of every object). Capability parity with the reference's ``_repr_utils.py`` (reference
_repr_utils.py:25-136): every user-facing object gets a readable
multi-section plain-text ``repr`` and a notebook ``_repr_html_``. The
implementation is independent — a tiny (title, sections) formatter pair
instead of per-object template strings — so all objects stay consistent
and new objects opt in with one ``_repr_sections()`` method.

A *section* is ``(name, items)`` where ``items`` is a list of strings
(possibly multi-line; nested object reprs indent naturally).
"""

from __future__ import annotations

import html as _html
import sys
import textwrap

__all__ = ["format_sections", "html_sections", "write_sections"]

_INDENT = "    "


def format_sections(title: str, sections: list[tuple[str, list[str]]]) -> str:
    """Plain-text sectioned repr::

        <Title>
            name:
                item
                item...
    """
    lines = [f"<{title}>"]
    for name, items in sections:
        if not items:
            continue
        lines.append(f"{_INDENT}{name}:")
        for item in items:
            lines.append(textwrap.indent(str(item).rstrip(), _INDENT * 2))
    return "\n".join(lines)


def html_sections(title: str, sections: list[tuple[str, list[str]]]) -> str:
    """Notebook HTML repr: a <details> block per section, monospace items."""
    parts = [
        "<div style='font-family:monospace'>",
        f"<b>&lt;{_html.escape(title)}&gt;</b>",
    ]
    for name, items in sections:
        if not items:
            continue
        body = "\n".join(_html.escape(str(item).rstrip()) for item in items)
        parts.append(
            f"<details open><summary><b>{_html.escape(name)}</b></summary>"
            f"<pre style='margin:0 0 0 2em'>{body}</pre></details>"
        )
    parts.append("</div>")
    return "".join(parts)


def write_sections(title: str, sections: list[tuple[str, list[str]]], buf=None) -> None:
    """Write the plain-text sectioned repr and a newline to ``buf`` (stdout)."""
    (buf or sys.stdout).write(format_sections(title, sections) + "\n")
