"""
Map-tile background layer for the scene renderer.

Counterpart of the reference's OpenStreetMap tile background
(reference: library/tpl/gui/components/map_tiles_component.py: tiles
fetched over HTTP into ``~/.cache/tplgui_map_tiles`` and drawn behind
the 2-D scene).  This framework renders scenes in the map's local
metric frame and runs in offline environments, so the layer reads
pre-seeded tiles from a local cache and falls back to a procedural
coordinate grid when no imagery exists — the drawing slot, caching
scheme, and view-extent logic match; only the network fetch is out of
scope (documented in PARITY.md non-goals).

Tile scheme: quadratic tiles of ``tile_m`` meters addressed by integer
(ix, iy) in the local metric frame; tile (ix, iy) covers
``[ix * tile_m, (ix+1) * tile_m) x [iy * tile_m, (iy+1) * tile_m)``.
Cache layout: ``<cache_dir>/<tile_m>/<ix>_<iy>.png``.  Seed it with any
georeferenced imagery resampled to the map frame (e.g. via
``tools/make_demo_data.py``-style preprocessing).

The port of ``tpl_tpu/gui/map_tiles.py`` (host code; the imports renamed).
"""

import os
import math

import numpy as np

DEFAULT_CACHE = os.path.join(
    os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
    "tpl_tpu_torch", "map_tiles")


class TileLayer:
    """Draws a raster background behind the scene axes.

    Stateful: decoded tiles are cached across frames (the GUI renders
    at a few Hz and the visible tile set changes slowly).
    """

    # decoded/absent tile keys kept in memory: bounds the caches to a few
    # screens' worth so a long drive cannot grow memory with distance
    MAX_DECODED = 64
    MAX_MISSING = 4096

    def __init__(self, cache_dir=None, tile_m=100.0, grid_step=10.0):
        self.cache_dir = os.path.expanduser(
            cache_dir or os.environ.get("TPL_TPU_MAP_TILES", DEFAULT_CACHE))
        self.tile_m = float(tile_m)
        self.grid_step = float(grid_step)
        self._decoded = {}       # insertion-ordered: FIFO eviction
        self._missing = set()

    # -- tile cache ----------------------------------------------------

    def _tile_path(self, ix, iy):
        return os.path.join(self.cache_dir, f"{int(self.tile_m)}",
                            f"{ix}_{iy}.png")

    def _load_tile(self, ix, iy):
        key = (ix, iy)
        if key in self._decoded:
            return self._decoded[key]
        if key in self._missing:
            return None
        path = self._tile_path(ix, iy)
        if not os.path.exists(path):
            if len(self._missing) >= self.MAX_MISSING:
                self._missing.clear()
            self._missing.add(key)
            return None
        import matplotlib.pyplot as plt
        img = plt.imread(path)
        while len(self._decoded) >= self.MAX_DECODED:
            self._decoded.pop(next(iter(self._decoded)))
        self._decoded[key] = img
        return img

    def tiles_in_view(self, x0, x1, y0, y1):
        ix0 = math.floor(x0 / self.tile_m)
        ix1 = math.floor(x1 / self.tile_m)
        iy0 = math.floor(y0 / self.tile_m)
        iy1 = math.floor(y1 / self.tile_m)
        return [(ix, iy)
                for ix in range(ix0, ix1 + 1)
                for iy in range(iy0, iy1 + 1)]

    # -- drawing ---------------------------------------------------------

    def draw(self, ax, x0, x1, y0, y1):
        """Draw the background for view extent [x0, x1] x [y0, y1]:
        cached imagery tiles where present, a coordinate grid where not."""
        drew_imagery = False
        for ix, iy in self.tiles_in_view(x0, x1, y0, y1):
            img = self._load_tile(ix, iy)
            if img is None:
                continue
            ax.imshow(img, origin="lower", zorder=0, interpolation="bilinear",
                      extent=(ix * self.tile_m, (ix + 1) * self.tile_m,
                              iy * self.tile_m, (iy + 1) * self.tile_m))
            drew_imagery = True

        if not drew_imagery:
            self._draw_grid(ax, x0, x1, y0, y1)

    def _draw_grid(self, ax, x0, x1, y0, y1):
        """Procedural fallback: light metric grid with tile boundaries
        emphasized, so the layer proves its slot without imagery data."""
        g = self.grid_step
        # integer line indices, not float positions: np.arange accumulates
        # error at large world coordinates, and `x % tile_m` lands near
        # tile_m (not 0) for slightly-below-boundary values, so a naive
        # `x % tile_m < eps` misclassifies major lines
        lines_per_tile = max(1, round(self.tile_m / g))
        for i in range(math.floor(x0 / g), math.ceil(x1 / g) + 1):
            major = i % lines_per_tile == 0
            ax.axvline(i * g, color="#3a3a3a" if major else "#2a2a2a",
                       lw=0.8 if major else 0.4, zorder=0)
        for i in range(math.floor(y0 / g), math.ceil(y1 / g) + 1):
            major = i % lines_per_tile == 0
            ax.axhline(i * g, color="#3a3a3a" if major else "#2a2a2a",
                       lw=0.8 if major else 0.4, zorder=0)
