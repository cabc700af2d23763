"""Sequence-diagram rendering for actor-model paths (ref: src/actor/model.rs:551-754).

Original implementation (not a port of the reference's drawing code): vertical
lifelines per actor, one row per path step, arrows for deliveries, self-loops
for timeouts/crashes/random selections. Returned as an SVG string for the
Explorer UI.
"""

from __future__ import annotations

from html import escape
from typing import Optional

LANE_W = 140
ROW_H = 36
TOP = 40
CHAR_W = 7


def sequence_diagram(model, path) -> Optional[str]:
    from .model import Crash, Deliver, DropEnv, SelectRandom, Timeout

    pairs = path.into_pairs() if hasattr(path, "into_pairs") else list(path)
    steps = [(s, a) for s, a in pairs if a is not None]
    n = len(model.actors)
    if n == 0:
        return None
    width = LANE_W * n + 40
    height = TOP + ROW_H * (len(steps) + 1) + 20

    def lane_x(i: int) -> int:
        return 20 + LANE_W * i + LANE_W // 2

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'font-family="monospace" font-size="12">',
        '<defs><marker id="arrow" markerWidth="10" markerHeight="10" refX="9" refY="3" '
        'orient="auto"><path d="M0,0 L9,3 L0,6 z"/></marker></defs>',
    ]
    for i, actor in enumerate(model.actors):
        name = actor.name() or f"Actor {i}"
        x = lane_x(i)
        parts.append(
            f'<text x="{x}" y="20" text-anchor="middle" font-weight="bold">'
            f"{escape(name)} (Id({i}))</text>"
        )
        parts.append(
            f'<line x1="{x}" y1="{TOP - 10}" x2="{x}" y2="{height - 10}" '
            'stroke="#bbb" stroke-dasharray="4,3"/>'
        )

    for row, (_state, action) in enumerate(steps):
        y = TOP + ROW_H * (row + 1)
        if isinstance(action, Deliver):
            x1, x2 = lane_x(int(action.src)), lane_x(int(action.dst))
            if x1 == x2:
                x2 = x1 + 24
            label = escape(repr(action.msg))
            parts.append(
                f'<line x1="{x1}" y1="{y}" x2="{x2}" y2="{y}" stroke="#333" '
                'marker-end="url(#arrow)"/>'
            )
            mid = (x1 + x2) // 2
            parts.append(
                f'<text x="{mid}" y="{y - 5}" text-anchor="middle">{label}</text>'
            )
        elif isinstance(action, DropEnv):
            env = action.envelope
            x1, x2 = lane_x(int(env.src)), lane_x(int(env.dst))
            if x1 == x2:
                x2 = x1 + 24
            parts.append(
                f'<line x1="{x1}" y1="{y}" x2="{x2}" y2="{y}" stroke="#c00" '
                'stroke-dasharray="5,3" marker-end="url(#arrow)"/>'
            )
            mid = (x1 + x2) // 2
            parts.append(
                f'<text x="{mid}" y="{y - 5}" text-anchor="middle" fill="#c00">'
                f"DROP {escape(repr(env.msg))}</text>"
            )
        else:
            if isinstance(action, Timeout):
                actor_i, label = int(action.id), f"timeout {action.timer!r}"
            elif isinstance(action, Crash):
                actor_i, label = int(action.id), "CRASH"
            elif isinstance(action, SelectRandom):
                actor_i, label = int(action.actor), f"random {action.random!r}"
            else:
                continue
            x = lane_x(actor_i)
            parts.append(
                f'<path d="M{x},{y - 8} C{x + 28},{y - 8} {x + 28},{y + 8} {x},{y + 8}" '
                'fill="none" stroke="#06c" marker-end="url(#arrow)"/>'
            )
            parts.append(
                f'<text x="{x + 32}" y="{y + 4}" fill="#06c">{escape(label)}</text>'
            )
    parts.append("</svg>")
    return "".join(parts)
