from .build_dataset import char_vocab_size, generate_char_vocab, get_dataset
from .gpt_datasets import (ContiguousGPTTrainDataset,
                           LazyNonContiguousGPTTrainDataset,
                           NonContiguousGPTTrainDataset)
from .offline import (CropAugmentedDataset, build_docs_corpus,
                      load_digits_mnist)
from .sampler import (ArrayDataset, IndexedDataset, NodeBatchIterator,
                      as_dataset, resolve_node_datasets)

__all__ = ["ArrayDataset", "IndexedDataset", "NodeBatchIterator",
           "as_dataset", "resolve_node_datasets",
           "ContiguousGPTTrainDataset", "NonContiguousGPTTrainDataset",
           "LazyNonContiguousGPTTrainDataset", "CropAugmentedDataset",
           "build_docs_corpus", "load_digits_mnist", "char_vocab_size",
           "generate_char_vocab", "get_dataset"]
