from vers_tpu_torch.utils.data import (
    load_vec_file,
    load_wiki_vector,
    synthetic_gaussian,
    synthetic_words_dataset,
    write_vec_file,
)
from vers_tpu_torch.utils.harness import recall_at_k, run_test, search_exhaustive

__all__ = [
    "load_vec_file",
    "load_wiki_vector",
    "write_vec_file",
    "synthetic_words_dataset",
    "synthetic_gaussian",
    "search_exhaustive",
    "recall_at_k",
    "run_test",
]
