"""Layered configuration system.

The port's copy of ``ovmr_tpu/utils/config.py``: a small yacs-compatible
``CfgNode`` with nested attribute access, yaml merging, ``KEY VALUE`` list
overrides and freezing, under the reference's key names, so the repo's yaml
configs merge unchanged. ``yaml`` is imported only where a file is read or
a config dumped.

The port's device keys live in a ``CUDA`` node where the JAX package has
its ``TPU`` node (:mod:`ovmr_tpu_torch.utils.defaults`). A ``TPU`` key met
in a yaml file or in the list overrides is read onto its ``CUDA`` twin
(``TPU_KEYS_ONTO_CUDA``); a ``TPU`` key with no twin is accepted only at
the JAX package's default (``TPU_KEYS_AT_DEFAULT``) and raises otherwise,
so no setting is dropped without a word.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List


class CfgNode(dict):
    """Nested dict with attribute access, freezing and yaml merge."""

    _FROZEN = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set '{name}': CfgNode is frozen")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set '{name}': CfgNode is frozen")
        super().__setitem__(name, value)

    # -- freeze ------------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other(self, other: "CfgNode" | dict, allow_new: bool = True) -> None:
        for k, v in other.items():
            if k == "TPU" and self._reads_tpu_onto_cuda():
                for dotted, value in _flatten_items(v):
                    self._merge_tpu_key(dotted, value)
                continue
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], CfgNode):
                    if not allow_new and k not in self:
                        raise KeyError(f"Unknown config key: {k}")
                    self[k] = CfgNode()
                self[k].merge_from_other(v, allow_new=allow_new)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Unknown config key: {k}")
                # yacs-style literal parsing: yaml reads "(224, 224)" as a
                # plain string; shipped configs rely on tuple/number syntax
                self[k] = _coerce(self.get(k), _parse_literal(v))

    def merge_from_file(self, path: str, allow_new: bool = True) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other(loaded, allow_new=allow_new)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge ``[KEY1, VAL1, KEY2, VAL2, ...]`` dotted-key overrides."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            parts = str(key).split(".")
            if parts[0] == "TPU" and self._reads_tpu_onto_cuda():
                self._merge_tpu_key(".".join(parts[1:]), raw)
                continue
            node = self
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _coerce(node.get(parts[-1]), _parse_literal(raw))

    # -- the JAX package's TPU node ------------------------------------------
    def _reads_tpu_onto_cuda(self) -> bool:
        return "CUDA" in self and "TPU" not in self

    def _merge_tpu_key(self, dotted: str, raw: Any) -> None:
        """Read ``TPU.<dotted>`` onto ``CUDA.<dotted>``, or check that a key
        with no CUDA twin holds the JAX package's default."""
        from .defaults import TPU_KEYS_AT_DEFAULT, TPU_KEYS_ONTO_CUDA

        value = _parse_literal(raw)
        if dotted in TPU_KEYS_ONTO_CUDA:
            node = self["CUDA"]
            parts = dotted.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(node.get(parts[-1]), value)
            return
        if dotted not in TPU_KEYS_AT_DEFAULT:
            raise KeyError(f"Unknown config key: TPU.{dotted}")
        default = TPU_KEYS_AT_DEFAULT[dotted]
        if _coerce(default, value) != default:
            raise ValueError(
                f"TPU.{dotted} = {value!r}: the PyTorch/CUDA port has no counterpart of "
                f"this TPU setting and runs only at its default ({default!r})"
            )

    # -- io ----------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfgNode({self.to_dict()})"


def _flatten_items(node: Any, prefix: str = ""):
    """``(dotted key, value)`` pairs of a nested mapping's leaves."""
    if not isinstance(node, dict):
        yield prefix, node
        return
    for k, v in node.items():
        yield from _flatten_items(v, f"{prefix}.{k}" if prefix else str(k))


def _parse_literal(value: Any) -> Any:
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(old: Any, new: Any) -> Any:
    """Coerce `new` to the type of `old` when that conversion is loss-free."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            if new.lower() in ("true", "1", "yes"):
                return True
            if new.lower() in ("false", "0", "no"):
                return False
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    return new
