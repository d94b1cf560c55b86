"""Pipeline stages: seeds, colour filtering, STM, trimap, matting, the
background model and harmonization."""
