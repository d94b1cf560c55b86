"""The masks that break connected-component label schemes, held against
the plain labels by the port's tests and by `chip_smoke.py`: a
checkerboard, whose pixels touch only diagonally (not 4-connected), a
snake across every 32-pixel tile edge, the full and the empty mask."""

HARD_MASKS = ("checkerboard", "snake", "full", "empty")


def hard_mask(name, h, w):
    """K3's hard masks, 0/255 f32: a checkerboard (only diagonal contacts,
    every pixel its own component), a one-pixel snake that crosses every
    edge of the 32x32 tiles, the full and the empty mask. The snake runs a
    full-width line in each tile row (crossing every vertical edge), turns
    down at alternate ends to the next row's line, and from each tile
    dips a 3-pixel-wide loop across the tile's bottom edge; it needs
    partial tiles of at least 5 pixels each way."""
    import numpy as np
    if name == "checkerboard":
        yy, xx = np.mgrid[0:h, 0:w]
        return ((yy + xx) % 2 == 0).astype(np.float32) * 255
    if name in ("full", "empty"):
        return np.full((h, w), 255.0 if name == "full" else 0.0, np.float32)
    assert name == "snake", name
    m = np.zeros((h, w), np.float32)
    rows = -(-h // 32)
    ys = [min(32 * r + 28, h - 1) for r in range(rows)]
    for r, y in enumerate(ys):
        m[y] = 255.0
        if r + 1 == rows:
            break
        m[y:ys[r + 1] + 1, w - 1 if r % 2 == 0 else 0] = 255.0
        yb = 32 * (r + 1) + 1          # one row past the tile's bottom edge
        for c in range(-(-w // 32)):
            x1 = 32 * c + min(12, w - 32 * c - 5)
            m[y:yb + 1, x1] = m[y:yb + 1, x1 + 2] = 255.0
            m[yb, x1:x1 + 3] = 255.0
    return m
