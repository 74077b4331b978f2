"""A stand-in for a weight pack that no kernel of the port reads, the
layout of a row-major weight buffer: every plan and launch refuses it,
and the refusal tests pass it beside the other operand mode's slab packs.
Only ``operand`` is read before a refusal."""
from types import SimpleNamespace

ROW_MAJOR = (None, SimpleNamespace(operand="row-major"))
