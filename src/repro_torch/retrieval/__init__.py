"""The retrieval serving tier (counterpart of `repro.retrieval`).

  service — UniversalVectorService: mixed-p micro-batching over a U-HNSW
            index, with the grouped and v1 baselines
  engine  — ServingEngine: the continuous-batching engine behind `serve`
  knn_lm  — KnnLM: kNN-LM scoring over a U-HNSW datastore of an LM's
            hidden states, the metric p chosen per call
"""

from repro_torch.retrieval.service import (  # noqa: F401
    InsertRequest,
    QueryRequest,
    QueueFull,
    UniversalVectorService,
)
