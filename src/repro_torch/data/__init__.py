from repro_torch.data.pipeline import DedupPipeline, SyntheticDocs, content_hash
