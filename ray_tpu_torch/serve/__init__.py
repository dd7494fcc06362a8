"""ray_tpu_torch.serve — the serving path of the port (the LLM engine)."""
