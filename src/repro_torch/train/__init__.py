"""Training (counterpart of `repro.train`):

  step        — TrainConfig, make_train_step (microbatches, int8 gradient
                compression, AdamW), init_train_state
  compression — int8 gradient quantization with error feedback
  monitor     — StepWatchdog (stragglers) and HeartbeatMonitor (hangs)
"""
