"""Camera and the exact tile-binned splat renderer."""
