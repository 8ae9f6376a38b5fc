"""Retrieval for retrieval-augmented training (RAT): the exact device store
(:mod:`.exact`), the native vector index (:mod:`.hnsw`), the host stores
(:mod:`.store`), the indexing pipelines (:mod:`.indexing`) and the RAT
training path (:mod:`.rat_pipeline`)."""
