from distlr_tpu_torch.data.libsvm import parse_libsvm_file, parse_libsvm_lines, write_libsvm  # noqa: F401
from distlr_tpu_torch.data.sharding import part_name, prepare_data_dir, shard_libsvm_file  # noqa: F401
from distlr_tpu_torch.data.synthetic import make_synthetic_dataset, write_synthetic_shards  # noqa: F401
