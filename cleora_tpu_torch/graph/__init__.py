from .columns import Column, RelationDescriptor, parse_fields, parse_line
from .builder import GraphData, build_graph
from .hashing import hash_entity, hash_entities, init_embeddings, xxh64

__all__ = [
    "Column", "RelationDescriptor", "parse_fields", "parse_line",
    "GraphData", "build_graph",
    "hash_entity", "hash_entities", "init_embeddings", "xxh64",
]
