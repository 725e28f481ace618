from distlr_tpu_torch.data.iterator import BlockedDataIter, DataIter, SparseDataIter  # noqa: F401
from distlr_tpu_torch.data.libsvm import (  # noqa: F401
    native_available,
    parse_libsvm_file,
    parse_libsvm_lines,
    write_libsvm,
)
from distlr_tpu_torch.data.sharding import part_name, prepare_data_dir, shard_libsvm_file  # noqa: F401
from distlr_tpu_torch.data.synthetic import make_synthetic_dataset, write_synthetic_shards  # noqa: F401
