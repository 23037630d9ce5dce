from repro_torch.tables.table import (
    ColumnMeta,
    ForeignKey,
    RelSchema,
    Schema,
    Table,
    bucket_capacity,
    db_from_numpy,
    float_dtype,
    int_dtype,
    is_wide,
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
    "float_dtype",
    "int_dtype",
    "is_wide",
    "pack_keys",
]
