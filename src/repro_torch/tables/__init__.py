from repro_torch.tables.table import (
    ColumnMeta,
    ForeignKey,
    RelSchema,
    Schema,
    Table,
    bucket_capacity,
    db_from_numpy,
    pack_keys,
)

__all__ = [
    "ColumnMeta",
    "ForeignKey",
    "RelSchema",
    "Schema",
    "Table",
    "bucket_capacity",
    "db_from_numpy",
    "pack_keys",
]
