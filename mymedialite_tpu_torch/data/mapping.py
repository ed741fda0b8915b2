"""External string ID <-> dense internal int ID mapping.

Counterpart of reference ``Data/Mapping.cs:147`` /
``IdentityMapping.cs``. Append-only: internal IDs are assigned densely in
first-seen order so they can index embedding-table rows directly.

The port's own copy of ``mymedialite_tpu/data/mapping.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations


class Mapping:
    """Append-only bidirectional mapping external-id-string <-> int."""

    def __init__(self):
        self._to_internal = {}
        self._to_original = []

    def __len__(self):
        return len(self._to_original)

    def __bool__(self):
        # an empty mapping is still a mapping — never falsy (guards against
        # `mapping or IdentityMapping()` silently swapping it out)
        return True

    @property
    def internal_ids(self):
        return range(len(self._to_original))

    @property
    def original_ids(self):
        return list(self._to_original)

    def to_internal(self, original_id: str) -> int:
        """Map an external id to its internal id, assigning a new one if unseen."""
        key = str(original_id)
        idx = self._to_internal.get(key)
        if idx is None:
            idx = len(self._to_original)
            self._to_internal[key] = idx
            self._to_original.append(key)
        return idx

    def to_original(self, internal_id: int) -> str:
        return self._to_original[internal_id]

    def contains(self, original_id: str) -> bool:
        return str(original_id) in self._to_internal

    def try_to_internal(self, original_id: str):
        return self._to_internal.get(str(original_id))

    # --- persistence (reference IO/EntityMappingExtensions.cs) ---

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for internal, original in enumerate(self._to_original):
                f.write(f"{original}\t{internal}\n")

    @staticmethod
    def load(path: str) -> "Mapping":
        m = Mapping()
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                original, internal = line.split("\t")
                idx = m.to_internal(original)
                if idx != int(internal):
                    raise ValueError(
                        f"non-contiguous mapping file {path}: {original} -> "
                        f"{internal}, expected {idx}")
        return m


class IdentityMapping(Mapping):
    """Identity mapping for already-dense integer IDs (reference IdentityMapping.cs).

    Internal id == int(external id); grows its size watermark on contact.
    """

    def __init__(self):
        super().__init__()
        self._max_seen = -1

    def __len__(self):
        return self._max_seen + 1

    def to_internal(self, original_id) -> int:
        idx = int(original_id)
        if idx < 0:
            raise ValueError(f"negative id {original_id}")
        if idx > self._max_seen:
            self._max_seen = idx
        return idx

    def to_original(self, internal_id: int) -> str:
        return str(internal_id)

    def contains(self, original_id) -> bool:
        try:
            return 0 <= int(original_id) <= self._max_seen
        except ValueError:
            return False

    def try_to_internal(self, original_id):
        try:
            return self.to_internal(original_id)
        except ValueError:
            return None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"IDENTITY\t{self._max_seen}\n")

    @staticmethod
    def load(path: str) -> "IdentityMapping":
        m = IdentityMapping()
        with open(path) as f:
            tag, max_seen = f.readline().split("\t")
            if tag != "IDENTITY":
                raise ValueError(f"not an identity-mapping file: {path}")
            m._max_seen = int(max_seen)
        return m
