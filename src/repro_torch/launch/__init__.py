"""Entry points (counterpart of `repro.launch`): `serve`, the LM's and the
retrieval tier's command line; `train`, the LM's training command line with
checkpoint / restart; `supervisor`, restart on failure; `mesh`, the
DeviceMesh over the process group and the production meshes' shapes."""
