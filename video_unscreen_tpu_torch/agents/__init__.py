"""Pipeline stages: color filtering and matting."""
