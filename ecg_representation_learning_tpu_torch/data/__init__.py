"""Data layer: PTB-XL labels and splits, the combined-HDF5 corpus (h5py,
imported when used), the synthetic corpora (numpy, and on the device), raw
corpus ingest (WFDB/CSV/bulk readers, the native decoder, the export jobs),
the input pipeline (device prefetch, sharded and mixed streams) and the
torch ``Dataset`` adapter."""
from .datasets import (EcgDataset, PtbxlSplits, compute_train_stats, export_ptbxl_labels,
                       get_ptbxl_splits, labels_to_multi_hot, load_ptbxl_from_export,
                       parse_scp_codes, split_by_strat_fold, synth_ecg, synth_ptbxl,
                       synth_ptbxl_device, write_combined_hdf5, write_labels_csv)
from .export import (export_combined, export_denoised, export_records_csv, export_shards,
                     get_rec_paths, read_shard_meta)
from .pipeline import MixedRecordStream, ShardedRecordStream, device_batches, prefetch_to_device
from .readers import BulkHdf5Reader, read_csv_record, read_header, read_many, read_record
from .torch_adapter import TorchPtbxlDataset, as_torch_dataset

__all__ = ['EcgDataset', 'PtbxlSplits', 'compute_train_stats', 'export_ptbxl_labels',
           'get_ptbxl_splits', 'labels_to_multi_hot', 'load_ptbxl_from_export',
           'parse_scp_codes', 'split_by_strat_fold', 'synth_ecg', 'synth_ptbxl',
           'synth_ptbxl_device', 'write_combined_hdf5', 'write_labels_csv',
           'export_combined', 'export_denoised', 'export_records_csv', 'export_shards',
           'get_rec_paths', 'read_shard_meta',
           'MixedRecordStream', 'ShardedRecordStream', 'device_batches', 'prefetch_to_device',
           'BulkHdf5Reader', 'read_csv_record', 'read_header', 'read_many', 'read_record',
           'TorchPtbxlDataset', 'as_torch_dataset']
