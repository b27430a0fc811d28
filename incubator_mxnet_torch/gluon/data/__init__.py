"""Datasets, samplers and the DataLoader (counterpart of
`incubator_mxnet_tpu/gluon/data/`).  `vision` holds MNIST,
FashionMNIST, CIFAR10 (from local files), `SyntheticImageDataset`,
`ImageRecordDataset`, `ImageFolderDataset` and the transforms."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
