"""Adapter pool: host-side bookkeeping for resident multi-LoRA slots.

Own copy of skypilot_tpu/serve/tenancy/adapter_pool.py (same names,
same behaviour; tests/test_torch_multitenant.py runs both under the same
operation sequences). The engine holds a device-side stack of `capacity`
loadable adapter slots per targeted projection (slot 0 is the permanent
base-model identity, all zeros; see models/transformer.LoRAStack). This
class owns everything about those slots EXCEPT the device writes:

- registry: named adapters and their host weights. Registration
  survives eviction: a request for an evicted adapter re-loads it on
  demand.
- residency: name → slot, mutated ONLY by the engine tick thread (the
  device write and the residency flip happen together between ticks,
  so a reader that sees a slot resident can trust its weights are live).
- refcounts: a slot is pinned while any request (queued or decoding)
  uses it; pinned slots are never eviction victims. LRU order over the
  refcount-0 residents picks the victim.
- exhaustion: every slot resident AND pinned ⇒ AdapterPoolExhaustedError
  (an EngineOverloadedError: the server sheds with Retry-After instead
  of corrupting a pinned slot).

Thread-safety: all state mutates under one lock. Recovery from a failed
tick swaps the whole pool for `fresh()` (registry survives, residency
and refs do not); in-flight requests release into the OLD object
harmlessly.
"""
from __future__ import annotations

import collections
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from skypilot_tpu_torch import exceptions

_NAME_RE = re.compile(r'^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$')


def validate_adapter_name(name: str) -> str:
    """Adapter names ride URL paths (DELETE /adapters/{name}): constrain
    them to a safe charset up front instead of escaping at every
    surface."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f'invalid adapter name {name!r}: expected 1-64 chars of '
            f'[A-Za-z0-9._-] starting alphanumeric')
    return name


def adapter_tree_from_lora_params(params: Mapping[str, Any]
                                  ) -> Dict[str, Any]:
    """Filter a LoRA param tree down to its lora_a/lora_b leaves: the
    nested structure ONE adapter has (the reference's models/lora
    layout; scanned trees keep the leading num_layers axis)."""

    def walk(node):
        if not isinstance(node, Mapping):
            return None
        out = {}
        for key, value in node.items():
            if key in ('lora_a', 'lora_b'):
                out[key] = value
            else:
                sub = walk(value)
                if sub:
                    out[key] = sub
        return out or None

    tree = walk(params)
    if tree is None:
        raise ValueError(
            'param tree holds no lora_a/lora_b leaves — not a LoRA '
            'adapter checkpoint')
    return tree


def _flatten(tree: Mapping[str, Any], prefix: str = ''
             ) -> List[Tuple[str, Any]]:
    items: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        value = tree[key]
        path = f'{prefix}/{key}' if prefix else key
        if isinstance(value, Mapping):
            items.extend(_flatten(value, path))
        else:
            items.append((path, value))
    return items


def save_adapter_npz(tree: Mapping[str, Any], path: str) -> None:
    """One adapter's weight tree as a flat npz (keys are /-joined
    paths): the POST /adapters/load wire format."""
    import numpy as np
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(tree)})


def load_adapter_npz(path: str) -> Dict[str, Any]:
    import numpy as np
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split('/')
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    if not out:
        raise ValueError(f'{path}: empty adapter archive')
    return out


class AdapterPool:
    """See module docstring. Slots are 1..capacity (0 = identity)."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError('adapter pool capacity must be >= 1')
        self.capacity = capacity
        self._lock = threading.Lock()
        self._registry: Dict[str, Any] = {}           # name -> host weights
        self._resident: Dict[str, int] = {}           # name -> slot
        self._slot_owner: Dict[int, str] = {}         # slot -> name
        self._refs: Dict[str, int] = {}               # name -> pins
        # LRU over residents: oldest-first; touched on pin and load.
        self._lru: 'collections.OrderedDict[str, None]' = \
            collections.OrderedDict()
        self.stats = {'loads': 0, 'evictions': 0, 'registered': 0,
                      'unregistered': 0, 'exhausted': 0}

    # ---------------- registry (any thread) ----------------

    def register(self, name: str, tree: Any) -> None:
        validate_adapter_name(name)
        with self._lock:
            self._registry[name] = tree
            self.stats['registered'] += 1

    def unregister(self, name: str) -> None:
        """Remove an adapter: new requests for it fail with
        UnknownAdapterError. Refuses while any request pins it (the
        server maps this to HTTP 409)."""
        with self._lock:
            if name not in self._registry:
                raise exceptions.UnknownAdapterError(
                    f'adapter {name!r} is not registered')
            if self._refs.get(name, 0) > 0:
                raise exceptions.AdapterInUseError(
                    f'adapter {name!r} is pinned by '
                    f'{self._refs[name]} in-flight request(s)')
            del self._registry[name]
            slot = self._resident.pop(name, None)
            if slot is not None:
                self._slot_owner.pop(slot, None)
            self._lru.pop(name, None)
            self._refs.pop(name, None)
            self.stats['unregistered'] += 1

    def registered_names(self) -> List[str]:
        with self._lock:
            return sorted(self._registry)

    # ---------------- residency / pinning ----------------

    def pin_if_resident(self, name: str) -> Optional[int]:
        """Fast path for submit(): pin an already-resident adapter and
        return its slot, or None (the caller then takes the tick-thread
        load path). Raises UnknownAdapterError for unregistered names
        so the shed happens before any queueing."""
        with self._lock:
            if name not in self._registry:
                raise exceptions.UnknownAdapterError(
                    f'adapter {name!r} is not registered '
                    f'(POST /adapters/load first)')
            slot = self._resident.get(name)
            if slot is None:
                return None
            self._refs[name] = self._refs.get(name, 0) + 1
            self._lru.move_to_end(name)
            return slot

    def acquire_for_load(self, name: str, pin: bool = True
                         ) -> Tuple[int, Optional[Any], Optional[str]]:
        """ENGINE TICK THREAD ONLY. Returns (slot, host_weights_to_write,
        evicted_name): the weights are None when the adapter was already
        resident (nothing to write). Picks a free slot, else evicts the
        LRU refcount-0 resident; raises AdapterPoolExhaustedError when
        every slot is pinned."""
        with self._lock:
            if name not in self._registry:
                raise exceptions.UnknownAdapterError(
                    f'adapter {name!r} is not registered')
            slot = self._resident.get(name)
            if slot is not None:
                if pin:
                    self._refs[name] = self._refs.get(name, 0) + 1
                self._lru.move_to_end(name)
                return slot, None, None
            evicted = None
            free = [s for s in range(1, self.capacity + 1)
                    if s not in self._slot_owner]
            if free:
                slot = free[0]
            else:
                victim = next(
                    (n for n in self._lru
                     if self._refs.get(n, 0) == 0), None)
                if victim is None:
                    self.stats['exhausted'] += 1
                    raise exceptions.AdapterPoolExhaustedError(
                        f'all {self.capacity} adapter slots are pinned '
                        f'by in-flight requests; retry, or size '
                        f'--max-adapters to the tenant mix')
                slot = self._resident.pop(victim)
                self._lru.pop(victim, None)
                self._slot_owner.pop(slot, None)
                self.stats['evictions'] += 1
                evicted = victim
            self._resident[name] = slot
            self._slot_owner[slot] = name
            self._lru[name] = None
            self._lru.move_to_end(name)
            if pin:
                self._refs[name] = self._refs.get(name, 0) + 1
            self.stats['loads'] += 1
            return slot, self._registry[name], evicted

    def abort_load(self, name: str, pinned: bool) -> None:
        """Roll back an acquire_for_load whose DEVICE WRITE failed: the
        residency map must never claim weights that did not land. The
        name leaves residency (slot freed), the pin (if taken) drops;
        the registry keeps the host weights so a retry just re-loads.
        An LRU victim the acquire evicted stays evicted (it was
        refcount-0 and reloads on demand)."""
        with self._lock:
            slot = self._resident.pop(name, None)
            if slot is not None:
                self._slot_owner.pop(slot, None)
            self._lru.pop(name, None)
            if pinned:
                refs = self._refs.get(name, 0)
                if refs > 0:
                    self._refs[name] = refs - 1

    def release(self, name: str) -> None:
        with self._lock:
            refs = self._refs.get(name, 0)
            if refs > 0:
                self._refs[name] = refs - 1

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._refs.get(name, 0)

    def resident_names(self) -> List[str]:
        """LRU order, oldest first."""
        with self._lock:
            return list(self._lru)

    def info(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{
                'name': name,
                'resident': name in self._resident,
                'slot': self._resident.get(name),
                'refs': self._refs.get(name, 0),
            } for name in sorted(self._registry)]

    def fresh(self) -> 'AdapterPool':
        """Successor pool after a failed tick: the registry (host
        weights) survives, residency/refcounts/LRU die with the
        generation, as the BlockPool swap does. The old object keeps
        absorbing stale releases harmlessly."""
        successor = AdapterPool(self.capacity)
        with self._lock:
            successor._registry = dict(self._registry)
        return successor
