"""Entry points (counterpart of `repro.launch`): `serve`, the retrieval
tier's command line."""
