"""Interactive keyboard teleop: the KeyBoard/CmdPanel equivalent (the
port's own copy of ``hector/io/keyboard.py``).

The reference runs a raw-terminal pthread that nudges four virtual joystick
axes by 0.025 per keypress (src/interface/KeyBoard.cpp:56-90,
include/interface/KeyBoard.h:25-26) and FSMState_Walking maps them onto the
velocity command envelope with invNormalize
(src/FSM/FSMState_Walking.cpp:30-33):

    w/s -> ly -> vx       in [-0.75, 0.75] m/s
    j/l -> rx -> vy       in [-0.25, 0.25] m/s
    a/d -> lx -> yaw rate in [-1.5, 1.5] rad/s
    i/k -> ry             (unused by Walking, kept for parity)
    space -> zero all axes (KeyBoard.cpp:51-53)

The pure-function half (axis update + normalization) is unit-tested; the
terminal half (raw mode + select) is the thin shell around it used by
``python -m hector_torch teleop``.
"""

from __future__ import annotations

import dataclasses
import select
import sys
import termios
import tty

SENSITIVITY = 0.025  # KeyBoard.h:25-26 (sensitivityLeft == sensitivityRight)

# teleop envelope, FSMState_Walking.cpp:30-33
VX_RANGE = (-0.75, 0.75)
VY_RANGE = (-0.25, 0.25)
YAW_RATE_RANGE = (-1.5, 1.5)


@dataclasses.dataclass(frozen=True)
class UserValue:
    """The four virtual joystick axes (include/interface/CmdPanel.h)."""

    lx: float = 0.0
    ly: float = 0.0
    rx: float = 0.0
    ry: float = 0.0


def _clamp(v: float) -> float:
    return max(-1.0, min(1.0, v))


def update_value(value: UserValue, key: str) -> UserValue:
    """One keypress -> new axes (KeyBoard::changeValue, KeyBoard.cpp:59-90;
    space zeroing from checkCmd, KeyBoard.cpp:51-53)."""
    k = key.lower()
    if k == " ":
        return UserValue()
    d = {
        "w": ("ly", +SENSITIVITY), "s": ("ly", -SENSITIVITY),
        "d": ("lx", +SENSITIVITY), "a": ("lx", -SENSITIVITY),
        "i": ("ry", +SENSITIVITY), "k": ("ry", -SENSITIVITY),
        "l": ("rx", +SENSITIVITY), "j": ("rx", -SENSITIVITY),
    }.get(k)
    if d is None:
        return value
    field, step = d
    return dataclasses.replace(
        value, **{field: _clamp(getattr(value, field) + step)})


def inv_normalize(value: float, lo: float, hi: float) -> float:
    """Map an axis in [-1, 1] onto [lo, hi] (the reference's invNormalize,
    include/common/Math/MathUtilities.h)."""
    return (value + 1.0) * 0.5 * (hi - lo) + lo


def value_to_command(value: UserValue):
    """Axes -> (vx, vy, yaw_rate) per FSMState_Walking.cpp:30-33."""
    return (inv_normalize(value.ly, *VX_RANGE),
            inv_normalize(value.rx, *VY_RANGE),
            inv_normalize(value.lx, *YAW_RATE_RANGE))


class RawTerminal:
    """Context manager: cbreak mode + nonblocking single-key reads
    (the tcsetattr/select loop of KeyBoard.cpp:14-22,97-115)."""

    def __enter__(self):
        self._fd = sys.stdin.fileno()
        self._old = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        termios.tcsetattr(self._fd, termios.TCSANOW, self._old)

    def poll_key(self, timeout: float = 0.0):
        """Return one pending key or None."""
        r, _, _ = select.select([sys.stdin], [], [], timeout)
        return sys.stdin.read(1) if r else None
