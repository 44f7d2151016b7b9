"""Name -> object registries.

The port's copy of ``ovmr_tpu/utils/registry.py``.

Mirrors the registry contract of the reference (Dassl.pytorch
``dassl/utils/registry.py:7-68``): string-keyed lookup populated by a
decorator, with duplicate-registration protection and helpful errors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    """A string-keyed registry of classes/functions.

    Usage::

        TRAINER_REGISTRY = Registry("TRAINER")

        @TRAINER_REGISTRY.register()
        class MM_CLS_OP: ...

        cls = TRAINER_REGISTRY.get("MM_CLS_OP")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any, force: bool = False) -> None:
        if name in self._obj_map and not force:
            raise KeyError(
                f"An object named '{name}' was already registered "
                f"in '{self._name}' registry"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, force: bool = False) -> Callable:
        if obj is None:
            # used as a decorator
            def deco(fn_or_class: Any) -> Any:
                self._do_register(fn_or_class.__name__, fn_or_class, force=force)
                return fn_or_class

            return deco

        # used as a function call
        self._do_register(obj.__name__, obj, force=force)
        return obj

    def register_alias(self, name: str, obj: Any, force: bool = False) -> Any:
        """Register `obj` under an additional explicit name (e.g. the
        stage-2 trainer is class ``CoOp`` but also reachable as ``MM_CLS``,
        the reference's config-directory name for it)."""
        self._do_register(name, obj, force=force)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"Object name '{name}' does not exist in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def registered_names(self) -> Iterable[str]:
        return sorted(self._obj_map)

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


def check_availability(requested: str, available: Iterable[str]) -> None:
    """Raise with a helpful message when `requested` is not in `available`."""
    available = list(available)
    if requested not in available:
        raise ValueError(
            f"'{requested}' is not available; expected one of {sorted(available)}"
        )
