"""ESP-NOW ARM/DISARM command link (the L5->L4 boundary, SURVEY.md §2A
A1/A2): the ArmMsg wire struct and the remote's hold-to-arm logic.

ArmMsg (m5stack_armDisarm.ino:13-18 == tof_esp32.ino:50-55):
    magic u8 = 0xC3 | cmd u8 (0=DISARM, 1=ARM) | seq u32le | t_ms u32le

The touch remote requires a 650 ms continuous hold to ARM and a tap to
DISARM (m5stack_armDisarm.ino:187, 211-249); the hub relays accepted
messages onto the companion UART as CTRL frames (tof_esp32.ino:131-138 —
see formats/scanframe.encode_ctrl_frame).  In the rebuild these feed the
`want_arm` timeline of replays and simulations.

The port's copy of micro_quad_slam_tpu/formats/armlink.py (the port imports
nothing of the JAX package); tests/test_torch_formats.py
holds what it writes and parses equal to the original's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

ARM_MAGIC = 0xC3
CMD_DISARM = 0
CMD_ARM = 1
HOLD_TO_ARM_MS = 650   # (m5stack_armDisarm.ino:187)


def encode_arm_msg(cmd: int, seq: int, t_ms: int) -> bytes:
    return struct.pack("<BBII", ARM_MAGIC, cmd & 0xFF,
                       seq & 0xFFFFFFFF, t_ms & 0xFFFFFFFF)


def decode_arm_msg(data: bytes) -> Optional[dict]:
    """Validate + decode one ArmMsg; None on reject (the hub's receive
    callback drops wrong-size, wrong-magic, unknown-cmd messages,
    tof_esp32.ino:104-116)."""
    if len(data) != 10:
        return None
    magic, cmd, seq, t_ms = struct.unpack("<BBII", data)
    if magic != ARM_MAGIC or cmd not in (CMD_ARM, CMD_DISARM):
        return None
    return {"cmd": cmd, "seq": seq, "t_ms": t_ms}


@dataclass
class ArmRemote:
    """The touch remote's hold-to-arm state machine: press() / release()
    at timestamps; emits ArmMsg events exactly when the reference UI
    would (hold >= 650 ms while disarmed => ARM; tap while armed =>
    DISARM)."""

    armed: bool = False
    seq: int = 0
    _press_ms: Optional[int] = None
    _fired: bool = False

    def press(self, t_ms: int) -> Optional[bytes]:
        if self._press_ms is None:
            self._press_ms = t_ms
            self._fired = False
        return self.tick(t_ms)

    def tick(self, t_ms: int) -> Optional[bytes]:
        """Call while held; fires the ARM once the hold threshold passes."""
        if (self._press_ms is not None and not self._fired
                and not self.armed
                and t_ms - self._press_ms >= HOLD_TO_ARM_MS):
            self._fired = True
            self.armed = True
            self.seq += 1
            return encode_arm_msg(CMD_ARM, self.seq, t_ms)
        return None

    def release(self, t_ms: int) -> Optional[bytes]:
        held = self._press_ms
        self._press_ms = None
        fired = self._fired
        self._fired = False
        if held is None or fired:
            return None
        if self.armed:  # tap-to-disarm
            self.armed = False
            self.seq += 1
            return encode_arm_msg(CMD_DISARM, self.seq, t_ms)
        return None
