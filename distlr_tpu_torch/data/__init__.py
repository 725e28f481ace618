from distlr_tpu_torch.data.iterator import BlockedDataIter, DataIter, SparseDataIter  # noqa: F401
from distlr_tpu_torch.data.libsvm import (  # noqa: F401
    native_available,
    parse_libsvm_file,
    parse_libsvm_lines,
    write_libsvm,
)
from distlr_tpu_torch.data.sharding import part_name, prepare_data_dir, shard_libsvm_file  # noqa: F401
from distlr_tpu_torch.data.synthetic import make_synthetic_dataset, write_synthetic_shards  # noqa: F401
from distlr_tpu_torch.data.hashing import (  # noqa: F401
    HashedFeatureEncoder,
    csr_to_padded_coo,
    csr_to_raw_ids,
    encode_blocked,
    hash_buckets,
    make_ctr_dataset,
    read_ctr_meta,
    read_raw_ctr_file,
    resolve_auto_block_size,
    split_field_groups,
    suggest_block_size,
    suggest_blocking,
    write_ctr_shards,
    write_raw_ctr_shards,
)
