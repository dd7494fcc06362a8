"""ray_tpu_torch.data — distributed datasets of columnar numpy blocks (ray
parity: python/ray/data). pyarrow and pandas are needed only by the
functions that take or give their objects."""

from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                      Schema, Table)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_arrow_refs,
    from_blocks,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_mongo,
    read_sql,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.datasource_api import (
    Datasource,
    FileBasedDatasource,
    read_datasource,
)
from ray_tpu_torch.data import preprocessors

__all__ = [
    "DataContext",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "Schema",
    "Table",
    "DataIterator",
    "Dataset",
    "from_arrow",
    "from_arrow_refs",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_mongo",
    "read_sql",
    "read_datasource",
    "Datasource",
    "FileBasedDatasource",
    "read_tfrecords",
    "read_webdataset",
    "preprocessors",
]
