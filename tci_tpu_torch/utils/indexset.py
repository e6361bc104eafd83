"""Bidirectional multi-index <-> position map and the TCI nesting predicate.

Parity reference: src/indexset.jl (IndexSet :34-73, pos :153-178, isnested
:291-317). Multi-indices are hashable tuples of 0-based ints.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, Iterator, List, Sequence, Tuple, TypeVar

T = TypeVar("T")


class IndexSet(Generic[T]):
    """Ordered set with O(1) lookup in both directions (element <-> position)."""

    __slots__ = ("toint", "fromint")

    def __init__(self, items: Iterable[T] = ()):  # positions are 0-based
        self.fromint: List[T] = [tuple(x) if isinstance(x, (list, tuple)) else x
                                 for x in items]
        self.toint: Dict[T, int] = {x: i for i, x in enumerate(self.fromint)}

    def __getitem__(self, i: int) -> T:
        return self.fromint[i]

    def __setitem__(self, i: int, x: T) -> None:
        x = tuple(x) if isinstance(x, (list, tuple)) else x
        self.toint[x] = i
        self.fromint[i] = x

    def __iter__(self) -> Iterator[T]:
        return iter(self.fromint)

    def __len__(self) -> int:
        return len(self.fromint)

    def __contains__(self, x) -> bool:
        x = tuple(x) if isinstance(x, (list, tuple)) else x
        return x in self.toint

    def __eq__(self, other) -> bool:
        if not isinstance(other, IndexSet):
            return NotImplemented
        return self.fromint == other.fromint

    def isempty(self) -> bool:
        return not self.fromint

    def push(self, x: T) -> None:
        x = tuple(x) if isinstance(x, (list, tuple)) else x
        self.fromint.append(x)
        self.toint[x] = len(self.fromint) - 1

    def pos(self, indices):
        """Position of an element, or list of positions for a list of elements."""
        if isinstance(indices, (list, tuple)) and indices and isinstance(
            indices[0], (list, tuple)
        ):
            return [self.toint[tuple(i)] for i in indices]
        if isinstance(indices, list):
            # ambiguous empty or flat multi-index; treat as a single element
            return self.toint[tuple(indices)]
        return self.toint[tuple(indices) if isinstance(indices, tuple) else indices]


def isnested(a: Sequence[Tuple], b: Sequence[Tuple], row_or_col: str = "row") -> bool:
    """Check the TCI nesting condition between index sets `a` and `b`.

    row: every element of b with its last entry dropped must be in a
    (I_l < I_{l+1}); col: every element of b with its first entry dropped must
    be in a (J_{l+1} < J_l). Parity: src/indexset.jl:291-317.
    """
    aset = {tuple(x) for x in a}
    for b_ in b:
        b_ = tuple(b_)
        if len(b_) == 0:
            return False
        if row_or_col == "row" and b_[:-1] not in aset:
            return False
        if row_or_col == "col" and b_[1:] not in aset:
            return False
    return True
