from .gpt_datasets import (ContiguousGPTTrainDataset,
                           LazyNonContiguousGPTTrainDataset,
                           NonContiguousGPTTrainDataset)
from .sampler import (ArrayDataset, IndexedDataset, NodeBatchIterator,
                      as_dataset, resolve_node_datasets)

__all__ = ["ArrayDataset", "IndexedDataset", "NodeBatchIterator",
           "as_dataset", "resolve_node_datasets",
           "ContiguousGPTTrainDataset", "NonContiguousGPTTrainDataset",
           "LazyNonContiguousGPTTrainDataset"]
