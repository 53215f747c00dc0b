"""
Bird's-eye camera panel for the HTTP GUI.

Counterpart of the reference's CARLA birdseye component (reference:
library/tpl/gui/components/carla_birdseye_component.py): there, an
external CARLA server publishes a top-down camera feed as ``cam_info``
(image, camera position ``(x, y, altitude)``, field of view) and the
component maps it into world coordinates via
``view_size = tan(fov / 2) * altitude * 2``
(carla_birdseye_component.py:33).  This framework keeps the same camera
contract and GUI slot with two interchangeable sources:

* an **external camera source** — any callable returning a
  :class:`CamInfo`; :meth:`BirdseyeView.connect_carla` builds one from a
  CARLA server when the ``carla`` client package is installed (it is
  not part of this offline build, so the import is gated and the
  documented fallback below keeps the panel functional), and
* a **synthetic top-down renderer** from the shared stores — a
  flat-shaded ground/road/vehicle view (camera-like: no axes, labels,
  or debug annotations, unlike the annotated scene plot), so the panel
  works in every environment this framework targets.

The port of ``tpl_tpu/gui/birdseye.py`` (host code; the imports renamed).
"""

import io
import math

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


class CamInfo:
    """The reference's cam_info contract: an image, the camera position
    ``(x, y, altitude)`` in world coordinates, and the field of view in
    degrees."""

    def __init__(self, img, pos, fov):
        self.img = img
        self.pos = pos
        self.fov = fov


def view_extent(pos, fov):
    """World extent covered by a downward camera at ``pos`` with
    ``fov`` degrees — the same mapping the reference applies when
    plotting the feed (carla_birdseye_component.py:33-36)."""
    view_size = math.tan(math.radians(fov / 2.0)) * pos[2] * 2.0
    x0 = pos[0] - view_size / 2.0
    y0 = pos[1] - view_size / 2.0
    return (x0, x0 + view_size, y0, y0 + view_size)


def _car_hull(car):
    from tpl_tpu_torch.simulation.state import SimCar
    return SimCar.get_convex_hull(car)


def _ego_hull(ego):
    from tpl_tpu_torch.simulation.state import SimEgo
    return SimEgo.get_convex_hull(ego)


class BirdseyeView:

    def __init__(self, altitude=60.0, fov=90.0, px=512, source=None):
        self.altitude = float(altitude)
        self.fov = float(fov)
        self.px = int(px)
        self.source = source          # callable -> CamInfo, or None
        self._carla_actors = []

    # -- external feed -------------------------------------------------

    def set_camera_source(self, source):
        """Install an external cam_info source (callable -> CamInfo)."""
        self.source = source

    def connect_carla(self, host="localhost", port=2000, altitude=None):
        """Build the camera source from a CARLA server: spawn a downward
        RGB camera above the spectator and stream its frames.  Requires
        the ``carla`` client package, which this offline build does not
        ship — without it this raises with the documented fallback (the
        synthetic renderer keeps the panel functional)."""
        try:
            import carla
        except ImportError as e:
            raise RuntimeError(
                "CARLA client package not installed; the birdseye panel "
                "falls back to the synthetic top-down renderer "
                "(see module docstring)") from e

        alt = self.altitude if altitude is None else float(altitude)
        client = carla.Client(host, port)
        client.set_timeout(5.0)
        world = client.get_world()
        bp = world.get_blueprint_library().find("sensor.camera.rgb")
        bp.set_attribute("image_size_x", str(self.px))
        bp.set_attribute("image_size_y", str(self.px))
        bp.set_attribute("fov", str(self.fov))
        spect = world.get_spectator().get_transform().location
        cam_tf = carla.Transform(
            carla.Location(x=spect.x, y=spect.y, z=alt),
            carla.Rotation(pitch=-90.0))
        sensor = world.spawn_actor(bp, cam_tf)
        self._carla_actors.append(sensor)

        latest = {}

        def on_image(image):
            arr = np.frombuffer(image.raw_data, dtype=np.uint8)
            arr = arr.reshape((image.height, image.width, 4))[:, :, :3]
            # CARLA's y axis points the other way than the map frame
            latest["cam"] = CamInfo(arr[:, :, ::-1],
                                    (cam_tf.location.x,
                                     -cam_tf.location.y, alt), self.fov)

        sensor.listen(on_image)
        self.source = lambda: latest.get("cam")
        return self.source

    # -- synthetic fallback --------------------------------------------

    def _render_synthetic(self, env, sim):
        """Flat-shaded top-down view from the shared stores."""
        pos = (sim.ego.x, sim.ego.y, self.altitude)
        x0, x1, y0, y1 = view_extent(pos, self.fov)

        dpi = 80
        fig = plt.figure(figsize=(self.px / dpi, self.px / dpi), dpi=dpi)
        ax = fig.add_axes([0, 0, 1, 1])
        ax.set_axis_off()
        ax.set_facecolor("#2c3a2c")                       # ground
        fig.patch.set_facecolor("#2c3a2c")

        with env.lock():
            local_map = env.local_map
            objects = list(env.predicted)

        if local_map is not None \
                and getattr(local_map, "boundary_left", None) is not None \
                and getattr(local_map, "boundary_right", None) is not None:
            road = np.concatenate([local_map.boundary_left,
                                   local_map.boundary_right[::-1]])
            ax.fill(road[:, 0], road[:, 1], color="#3d3d3d", zorder=1)
            ax.plot(local_map.path[:, 0], local_map.path[:, 1],
                    color="#e8e8e8", lw=0.8, ls=(0, (6, 6)), zorder=2)

        for sc in sim.cars:
            h = _car_hull(sc)
            ax.fill(h[:, 0], h[:, 1], color="#b4452c", zorder=3)
        for obj in objects:
            hull = getattr(obj, "hull", None)
            if hull is not None and len(np.atleast_2d(hull)) >= 3:
                p = np.asarray(obj.pos) + np.atleast_2d(hull)
                ax.fill(p[:, 0], p[:, 1], facecolor="none",
                        edgecolor="#e0c040", lw=1.0, zorder=4)
        h = _ego_hull(sim.ego)
        ax.fill(h[:, 0], h[:, 1], color="#3c78b4", zorder=5)

        ax.set_xlim(x0, x1)
        ax.set_ylim(y0, y1)
        ax.set_aspect("equal")
        fig.canvas.draw()
        rgb = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return rgb, (x0, x1, y0, y1)

    # -- frames --------------------------------------------------------

    def frame(self, env, sim):
        """Current bird's-eye frame -> (rgb array, world extent).

        An installed external source wins (its frames map into world
        coordinates exactly as the reference does); until it delivers
        its first image — or without one — the synthetic renderer
        answers."""
        if self.source is not None:
            cam = self.source()
            if cam is not None:
                return cam.img, view_extent(cam.pos, cam.fov)
        return self._render_synthetic(env, sim)

    def png(self, env, sim):
        rgb, _extent = self.frame(env, sim)
        buf = io.BytesIO()
        plt.imsave(buf, np.asarray(rgb).astype(np.uint8), format="png")
        return buf.getvalue()
