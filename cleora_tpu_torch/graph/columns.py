"""Column specification DSL.

Parity with the reference column config (the reference's ``src/configuration.rs:19-70``
``parse_fields``/``validate_column_modifiers``) and the relation descriptor factory
(the reference's ``src/sparse_matrix.rs:5-46``).

Grammar: space-separated column specs; each spec is ``modifier::modifier::name``
where modifiers are ``complex`` / ``reflexive`` (case-insensitive) and the last
token is the column name.  ``reflexive`` requires ``complex``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Column:
    name: str
    complex: bool = False
    reflexive: bool = False


@dataclass
class RelationDescriptor:
    """One (column_a, column_b) relation; mirrors SparseMatrixDescriptor."""

    col_a_id: int
    col_a_name: str
    col_b_id: int
    col_b_name: str


def parse_fields(columns: str) -> List[Column]:
    cols = columns.split(" ")
    out: List[Column] = []
    for col in cols:
        parts = col.split("::")
        complex_ = False
        reflexive = False
        if len(parts) > 1:
            column_name = parts[-1]
            for part in parts[:-1]:
                low = part.lower()
                if low == "complex":
                    complex_ = True
                elif low == "reflexive":
                    reflexive = True
                else:
                    raise ValueError(f"Unrecognized column field modifier: {part}")
        else:
            column_name = col
        out.append(Column(name=column_name, complex=complex_, reflexive=reflexive))
    for col in out:
        if col.reflexive and not col.complex:
            raise ValueError(
                "A field cannot be REFLEXIVE but NOT COMPLEX. "
                f"It does not make sense: {col.name}"
            )
    return out


def create_relation_descriptors(cols: List[Column]) -> List[RelationDescriptor]:
    """All pairwise relations: cartesian i<j plus a virtual reflexive pair.

    Reference: create_sparse_matrices_descriptors (src/sparse_matrix.rs:15-46).
    A reflexive column i yields the pair (i, num_fields + k) for the k-th
    reflexive column; the virtual id aliases the same node span.
    """
    descs: List[RelationDescriptor] = []
    num_fields = len(cols)
    reflexive_count = 0
    for i in range(num_fields):
        for j in range(i, num_fields):
            if i < j:
                descs.append(RelationDescriptor(i, cols[i].name, j, cols[j].name))
            elif i == j and cols[i].reflexive:
                new_j = num_fields + reflexive_count
                reflexive_count += 1
                descs.append(RelationDescriptor(i, cols[i].name, new_j, cols[j].name))
    return descs


def create_relation_descriptor(cols: List[Column]) -> RelationDescriptor:
    descs = create_relation_descriptors(cols)
    if len(descs) != 1:
        raise ValueError(
            "More than one relation! Adjust your columns so there is only one relation."
        )
    return descs[0]


def parse_line(line: str) -> List[List[str]]:
    """Split a hyperedge line into columns of entity tokens.

    Parity with parse_line (src/pipeline.rs:223-240): tab-separated if the line
    contains a tab, else comma-separated (with per-column trim), else a single
    column; entities within a column are space-separated.
    """
    trimmed = line.strip()
    if "\t" in trimmed:
        return [c.split(" ") for c in trimmed.split("\t")]
    if "," in trimmed:
        return [c.strip().split(" ") for c in trimmed.split(",")]
    return [trimmed.split(" ")]
