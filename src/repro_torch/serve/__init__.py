"""LM serving: the batched prefill + decode engine (`engine.ServeEngine`)."""
