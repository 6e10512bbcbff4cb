"""Label-mapping file reader.

The port's own copy of ``r3d_tpu/data/mapping.py``: a text file with
``<idx> <name>`` per line, mapped to ``{name: idx}``.
"""

from __future__ import annotations

from typing import Dict


def read_mapping_dict(file_path: str) -> Dict[str, int]:
    """Read an action-index mapping txt into ``{action_name: index}``.

    Lines are ``"<index> <name>"``; a trailing newline is tolerated.
    """
    actions: Dict[str, int] = {}
    with open(file_path, "r") as f:
        for line in f.read().split("\n"):
            if not line.strip():
                continue
            parts = line.split()
            actions[parts[1]] = int(parts[0])
    return actions
