"""The data layer: image reading, datasets, pipelines, samplers, loaders."""
