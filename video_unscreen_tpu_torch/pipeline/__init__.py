"""Mode pipelines; green mode with the chroma seed is ported."""
