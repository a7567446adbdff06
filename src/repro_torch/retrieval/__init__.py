"""The retrieval serving tier (counterpart of `repro.retrieval`).

  service — UniversalVectorService: mixed-p micro-batching over a U-HNSW
            index, with the grouped and v1 baselines
  engine  — ServingEngine: the continuous-batching engine behind `serve`

The kNN-LM integration (`repro.retrieval.knn_lm`) waits for the baselines'
port (ROADMAP item 10).
"""

from repro_torch.retrieval.service import (  # noqa: F401
    InsertRequest,
    QueryRequest,
    QueueFull,
    UniversalVectorService,
)
