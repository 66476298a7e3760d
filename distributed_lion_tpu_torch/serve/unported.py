"""The parts of serving the port does not serve yet, refused by name.

One helper for every refusal site (the paged decodes' arguments, the
engine's config, ``cli/run_serve``'s flags), each message naming the
argument, its value and the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

ITEM_D = ("is serving's extension (tensor- and expert-parallel serving, speculation, the MoE "
          "routing stats), ROADMAP Queue 1 item 12(d)")
ITEM_E = "is the serving fleet's, ROADMAP Queue 1 item 12(e)"


def refuse(item: str, args: Mapping[str, Any],
           defaults: Optional[Mapping[str, Any]] = None) -> None:
    """Raise ``NotImplementedError`` naming the first of ``args`` (label →
    value) that is set, and ``item``: a value is set when it differs from
    its label's entry in ``defaults``, or, with no entry, when it is not
    None, False, 0 or ""."""
    defaults = defaults or {}
    for label, value in args.items():
        if label in defaults:
            set_ = value != defaults[label]
        else:
            set_ = value not in (None, False, 0, "")
        if set_:
            raise NotImplementedError(f"{label}={value!r} {item}")
