"""Huffman tree: flat-array nodes, reference-faithful construction, bit serde.

Array-first redesign of the reference's `huff_coding/src/tree/` — arrays
instead of boxed node graphs (SURVEY §7 "arrays, not trees"):

* Nodes live in flat numpy-friendly arrays (``left``/``right``/``letters``/
  ``weights``); a leaf has ``left == right == -1``.  The reference's
  ``HuffBranch``/``HuffLeaf`` pointer graph (`branch.rs:158-162`,
  `leaf.rs:25-29`) maps 1:1 onto node indices.
* Construction emulates Rust's ``std::collections::BinaryHeap`` *exactly*
  (sift order and all) over the reversed-``Ord`` wrapper the reference uses
  (`branch_heap.rs:64-83`), comparing by weight only (`leaf.rs:31-35`).
  Result: for any deterministic seed order (e.g. ``ByteWeights``' ascending
  byte iteration, `weights.rs:423-442`) our tree shape — and therefore the
  compressed bitstream — is bit-identical to the reference binary's.
* Code assignment: left child appends 0, right appends 1
  (`tree_inner.rs:422-440`); a degenerate single-letter tree gets code ``0``
  (`tree_inner.rs:310-315`).
* Binary serde (`as_bin`/`try_from_bin`): pre-order, ``1`` per joint node,
  ``0`` + ``size_of::<L>()*8`` big-endian letter bits per leaf
  (`tree_inner.rs:632-668`, decode `tree_inner.rs:522-604`) with strict
  exact-consumption checks.

The dense LUT export (:meth:`HuffTree.encode_tables`) and the byte-driven DFA
(:meth:`HuffTree.decode_dfa`) are the array forms the device kernels and the C++
runtime consume; the bit-serial walks of the reference (`comp.rs:493-516`)
never run on the hot path here.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .bits import BitString, calc_padding_bits
from .letters import LetterType, U8, letter_type
from .weights import weights_items

__all__ = ["HuffTree", "Code", "FromBinError", "EmptyWeightsError"]


class FromBinError(ValueError):
    """Raised when a tree's binary form is malformed (`tree_inner.rs:673-700`)."""


class EmptyWeightsError(ValueError):
    """Raised for empty weights — the reference panics with exactly
    ``"provided empty weights"`` (`tree_inner.rs:283-285`)."""

    def __init__(self) -> None:
        super().__init__("provided empty weights")


class Code:
    """A Huffman code: ``value`` holds ``length`` MSB-first bits."""

    __slots__ = ("value", "length")

    def __init__(self, value: int, length: int):
        self.value = value
        self.length = length

    def __iter__(self):
        v, n = self.value, self.length
        for i in range(n):
            yield (v >> (n - 1 - i)) & 1

    def __len__(self) -> int:
        return self.length

    def __eq__(self, other) -> bool:
        if isinstance(other, Code):
            return self.value == other.value and self.length == other.length
        if isinstance(other, (str, list, tuple)):
            return self.to01() == "".join(str(int(b)) for b in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.value, self.length))

    def to01(self) -> str:
        return format(self.value, f"0{self.length}b") if self.length else ""

    def bits(self) -> BitString:
        return BitString(self.value, self.length)

    def __repr__(self) -> str:
        return f"Code('{self.to01()}')"


# ---------------------------------------------------------------------------
# Rust BinaryHeap emulation
# ---------------------------------------------------------------------------
class _RustBinaryHeap:
    """Bit-faithful emulation of ``std::collections::BinaryHeap``.

    The reference wraps branches in ``HuffBranchHeapItem`` whose ``Ord`` is the
    *reverse* of the leaf order (`branch_heap.rs:67-71`), and leaves order by
    weight only (`leaf.rs:31-35`), so equal weights compare Equal and the pop
    order of ties is decided purely by the heap's sift mechanics.  We replicate
    Rust's ``sift_up`` / ``sift_down_to_bottom`` hole-based implementation so
    tie resolution matches the reference binary exactly (SURVEY §2
    "Semantics that matter for bit-exactness").

    Items are opaque; ``key(item)`` returns the weight.  All comparisons below
    are in *wrapper* order: ``a <= b  ⇔  key(b) <= key(a)``.
    """

    __slots__ = ("data", "key")

    def __init__(self, key):
        self.data: List = []
        self.key = key

    def __len__(self) -> int:
        return len(self.data)

    def _le(self, a, b) -> bool:
        # wrapper `a <= b` with reversed Ord ⇒ weight(b) <= weight(a)
        return self.key(b) <= self.key(a)

    def push(self, item) -> None:
        self.data.append(item)
        self._sift_up(0, len(self.data) - 1)

    def _sift_up(self, start: int, pos: int) -> int:
        data = self.data
        element = data[pos]
        while pos > start:
            parent = (pos - 1) // 2
            if self._le(element, data[parent]):
                break
            data[pos] = data[parent]
            pos = parent
        data[pos] = element
        return pos

    def pop(self):
        """``BinaryHeap::pop`` — with the reversed wrapper this pops the
        minimum weight (`branch_heap.rs:48-50`)."""
        data = self.data
        item = data.pop()
        if data:
            item, data[0] = data[0], item
            self._sift_down_to_bottom(0)
        return item

    def _sift_down_to_bottom(self, pos: int) -> None:
        data = self.data
        end = len(data)
        start = pos
        element = data[pos]
        child = 2 * pos + 1
        # while both children exist: unconditionally descend to the "greater"
        # child (ties pick the right child: `<=` at branch_heap-era Rust).
        while child <= end - 2:
            if self._le(data[child], data[child + 1]):
                child += 1
            data[pos] = data[child]
            pos = child
            child = 2 * pos + 1
        if child == end - 1:
            data[pos] = data[child]
            pos = child
        data[pos] = element
        self._sift_up(start, pos)


# ---------------------------------------------------------------------------
# HuffTree
# ---------------------------------------------------------------------------
class HuffTree:
    """A Huffman tree over letters, stored as flat node arrays.

    Node ``i`` has ``letters[i]`` (``None`` for a joint node), ``weights[i]``,
    and children ``left[i]``/``right[i]`` (``-1`` for leaves).  ``root`` is the
    root node index.  Functional equivalent of the reference ``HuffTree``
    (`tree_inner.rs:193-196`) plus the dense-table exports the device/C++ paths
    need.
    """

    def __init__(
        self,
        left: Sequence[int],
        right: Sequence[int],
        letters: Sequence[Optional[Hashable]],
        weights: Sequence[int],
        root: int,
    ):
        self.left = np.asarray(left, dtype=np.int32)
        self.right = np.asarray(right, dtype=np.int32)
        self.letters: List[Optional[Hashable]] = list(letters)
        self.weights = np.asarray(weights, dtype=np.int64)
        self.root = int(root)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_weights(cls, weights) -> "HuffTree":
        """Build the tree with the classic heap loop (`tree_inner.rs:281-320`)
        via the exact Rust-BinaryHeap emulation (tie-compatible)."""
        items = weights_items(weights)
        if not items:
            raise EmptyWeightsError()

        letters: List[Optional[Hashable]] = []
        node_weights: List[int] = []
        left: List[int] = []
        right: List[int] = []

        def new_node(letter, weight, l=-1, r=-1) -> int:
            letters.append(letter)
            node_weights.append(weight)
            left.append(l)
            right.append(r)
            return len(letters) - 1

        heap = _RustBinaryHeap(key=lambda i: node_weights[i])
        for letter, weight in items:
            heap.push(new_node(letter, int(weight)))

        while len(heap) > 1:
            lo = heap.pop()
            hi = heap.pop()
            heap.push(
                new_node(None, node_weights[lo] + node_weights[hi], lo, hi)
            )
        root = heap.pop()
        return cls(left, right, letters, node_weights, root)

    # -- basic structure ---------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.letters)

    def is_leaf(self, node: int) -> bool:
        return self.left[node] < 0

    def num_leaves(self) -> int:
        return int(np.count_nonzero(self.left < 0))

    # -- codes -------------------------------------------------------------
    def read_codes(self) -> Dict[Hashable, Code]:
        """Letter -> code map (`tree_inner.rs:356-419`): left appends 0,
        right appends 1; single-leaf root gets code ``0``."""
        codes: Dict[Hashable, Code] = {}
        if self.is_leaf(self.root):
            codes[self.letters[self.root]] = Code(0, 1)
            return codes
        # iterative pre-order walk; stack entries: (node, value, length)
        stack = [
            (int(self.right[self.root]), 1, 1),
            (int(self.left[self.root]), 0, 1),
        ]
        while stack:
            node, value, length = stack.pop()
            if self.is_leaf(node):
                codes[self.letters[node]] = Code(value, length)
            else:
                stack.append((int(self.right[node]), (value << 1) | 1, length + 1))
                stack.append((int(self.left[node]), value << 1, length + 1))
        return codes

    def max_code_len(self) -> int:
        if self.is_leaf(self.root):
            return 1
        depth = 0
        stack = [(self.root, 0)]
        while stack:
            node, d = stack.pop()
            if self.is_leaf(node):
                depth = max(depth, d)
            else:
                stack.append((int(self.left[node]), d + 1))
                stack.append((int(self.right[node]), d + 1))
        return depth

    # -- dense tables for vectorized kernels -------------------------------
    def encode_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense ``(len[256] uint8, code[256] uint64)`` LUTs for the u8 fast
        path.  ``len == 0`` marks a byte absent from the tree (encoding it is
        the reference's ``CompressError``, `comp.rs:427-432`).  Requires all
        letters to be ints in [0, 256) and max code length <= 64."""
        lens = np.zeros(256, dtype=np.uint8)
        codes = np.zeros(256, dtype=np.uint64)
        for letter, code in self.read_codes().items():
            if not isinstance(letter, (int, np.integer)) or not 0 <= letter < 256:
                raise TypeError("encode_tables requires u8 letters")
            if code.length > 64:
                raise OverflowError("code longer than 64 bits; use generic path")
            lens[letter] = code.length
            codes[letter] = code.value
        return lens, codes

    def node_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(left, right, letter_or_minus1) int32 arrays for native walkers."""
        lets = np.array(
            [-1 if l is None else int(l) for l in self.letters], dtype=np.int32
        )
        return self.left.copy(), self.right.copy(), lets

    def decode_dfa(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Byte-driven DFA over internal-node states for table decoding.

        States are the internal (joint) nodes renumbered 0..S-1 with the root
        as state 0 (a lone-leaf root is handled by callers separately).  For
        each (state, input byte) the table stores: next state, number of
        letters emitted (0..8), and the emitted u8 letters.  One lookup
        consumes 8 compressed bits — the vectorized replacement for the
        reference's per-bit pointer chase (`comp.rs:493-516`).

        Returns ``(next_state[S,256] int16, emit_count[S,256] uint8,
        emit_syms[S,256,8] uint8, state_of_node[num_nodes] int16)``.
        """
        internal = [n for n in range(self.num_nodes) if not self.is_leaf(n)]
        if not internal:
            raise ValueError("decode_dfa needs at least one internal node")
        # root first
        internal.sort(key=lambda n: (n != self.root,))
        state_of_node = np.full(self.num_nodes, -1, dtype=np.int16)
        for s, n in enumerate(internal):
            state_of_node[n] = s
        S = len(internal)
        next_state = np.zeros((S, 256), dtype=np.int16)
        emit_count = np.zeros((S, 256), dtype=np.uint8)
        emit_syms = np.zeros((S, 256, 8), dtype=np.uint8)
        root = self.root
        left, right = self.left, self.right
        letters = self.letters
        for s, start in enumerate(internal):
            for byte in range(256):
                node = start
                count = 0
                for bit_i in range(7, -1, -1):
                    bit = (byte >> bit_i) & 1
                    node = int(right[node] if bit else left[node])
                    if left[node] < 0:  # leaf
                        emit_syms[s, byte, count] = int(letters[node])
                        count += 1
                        node = root
                next_state[s, byte] = state_of_node[node]
                emit_count[s, byte] = count
        return next_state, emit_count, emit_syms, state_of_node

    # -- binary serde ------------------------------------------------------
    def as_bin(self, ltype: LetterType | str = U8) -> BitString:
        """Pre-order bit encoding (`tree_inner.rs:632-668`)."""
        lt = letter_type(ltype)
        out = BitString()
        stack = [self.root]
        while stack:
            node = stack.pop()
            if self.is_leaf(node):
                out.push(0)
                out.push_uint(
                    int.from_bytes(lt.as_be_bytes(self.letters[node]), "big"),
                    lt.size_bits,
                )
            else:
                out.push(1)
                stack.append(int(self.right[node]))
                stack.append(int(self.left[node]))
        return out

    @classmethod
    def try_from_bin(cls, bin_bits: BitString, ltype: LetterType | str = U8) -> "HuffTree":
        """Parse the pre-order form (`tree_inner.rs:522-604`).  All weights are
        0 in the result (`tree_inner.rs:446-447`); errors on truncated or
        leftover bits."""
        lt = letter_type(ltype)
        letters: List[Optional[Hashable]] = []
        weights: List[int] = []
        left: List[int] = []
        right: List[int] = []

        def new_node(letter, l=-1, r=-1) -> int:
            letters.append(letter)
            weights.append(0)
            left.append(l)
            right.append(r)
            return len(letters) - 1

        pos = 0
        n = len(bin_bits)

        def take_bit() -> int:
            nonlocal pos
            if pos >= n:
                raise FromBinError(
                    "Provided BitVec is too small for an encoded HuffTree"
                )
            b = bin_bits[pos]
            pos += 1
            return b

        def take_letter() -> Hashable:
            nonlocal pos
            if pos + lt.size_bits > n:
                raise FromBinError(
                    "Provided BitVec is too small for an encoded HuffTree"
                )
            value = 0
            for _ in range(lt.size_bits):
                value = (value << 1) | bin_bits[pos]
                pos += 1
            return lt.try_from_be_bytes(value.to_bytes(lt.size_bytes, "big"))

        # iterative pre-order parse: build children first via explicit stack.
        # frame: [pending_children_remaining, left_child, parent_frame...]
        def parse() -> int:
            # stack of unfinished joint nodes: (left_child_or_None,)
            stack: List[List[Optional[int]]] = []
            while True:
                if take_bit():
                    stack.append([None])
                    continue
                node = new_node(take_letter())
                while True:
                    if not stack:
                        return node
                    top = stack[-1]
                    if top[0] is None:
                        top[0] = node
                        break
                    l = top[0]
                    stack.pop()
                    node = new_node(None, l, node)

        root = parse()
        if pos != n:
            raise FromBinError("Provided BitVec is too big for an encoded HuffTree")
        return cls(left, right, letters, weights, root)

    # -- misc --------------------------------------------------------------
    def __eq__(self, other) -> bool:
        """Structural equality: same shape and letters (weights ignored,
        matching what ``read_codes`` equality means in the reference tests)."""
        if not isinstance(other, HuffTree):
            return NotImplemented
        return self.read_codes() == other.read_codes()

    def __repr__(self) -> str:
        return f"HuffTree(num_nodes={self.num_nodes}, root={self.root})"
