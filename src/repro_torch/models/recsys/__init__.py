"""DIN, the recommender of the port (the counterpart of ``repro.models.recsys``):
``din`` (the model), ``embedding_bag`` (bags, the sum on the CUDA kernel),
``steps`` (train, serve and retrieval steps, synthetic batches) and
``convert`` (weights carried across from the JAX reference)."""
