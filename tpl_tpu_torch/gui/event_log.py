"""
Event log: announces state transitions out of the shared stores.

The reference GUI's VoiceLog view (library/tpl/gui/views/voice_log.py)
watches the env and planning stores and speaks transition events through
the operator's headset: environment resets, IMU/RTK state changes,
autonomous-mode engagement, and planner reinit messages.  This framework's
GUI is an HTTP process, so the same announcer publishes a timestamped
event feed instead (rendered on the live page and served as
``/events.json``); the 3-second per-event rate limit of the reference's
speech output is kept so a flapping signal cannot flood the log
(voice_log.py:36-42).

The port of ``tpl_tpu/gui/event_log.py`` (host code; the imports renamed).
"""

import time


_IMU_MSGS = {
    0: "Error: No GPS available",
    1: "Warning: No RTK available",
    2: "Warning: RTK floating",
    3: "Info: RTK locked",
}


class EventLog:
    """Transition watcher over the env + planning stores.

    ``update()`` snapshots the watched fields and appends one entry per
    transition to a bounded ring; ``events()`` returns the most recent
    entries newest-first.  (voice_log.py:58-107)
    """

    def __init__(self, env, planning_store, max_events=200,
                 min_interval=3.0):
        self.env = env
        self.planning_store = planning_store
        self.max_events = max_events
        self.min_interval = min_interval

        self.last_emit_time = 0.0
        self.last_reset_counter = None
        self.last_imu_state = None
        self.last_automated = None
        self.last_reinit_msgs = {}

        self._events = []

    def _emit(self, t, msg):
        """t: env time of the transition (wall time for planner events)."""
        now = time.time()
        if now - self.last_emit_time < self.min_interval:
            return
        self.last_emit_time = now
        self._events.append(dict(t=float(t), msg=str(msg)))
        del self._events[:-self.max_events]

    def update(self):
        try:
            self.env.revalidate()
            with self.env.lock():
                t = self.env.t
                imu_state = self.env.vehicle_state.imu_state
                automated = self.env.vehicle_state.automated
                reset_counter = self.env.reset_counter

            if (self.last_reset_counter is not None
                    and self.last_reset_counter != reset_counter):
                self._emit(t, "Warning: Environment reset")
            self.last_reset_counter = reset_counter

            if (self.last_imu_state is not None
                    and self.last_imu_state != imu_state):
                self._emit(t, _IMU_MSGS.get(
                    imu_state, f"IMU state {imu_state}"))
            self.last_imu_state = imu_state

            if (self.last_automated is not None
                    and self.last_automated != automated):
                self._emit(t, "Autonomous mode engaged" if automated
                           else "Autonomous mode disengaged")
            self.last_automated = automated
        except Exception:
            pass

        # planner reinit messages: the reference watches one hardcoded
        # planner (voice_log.py:96-103); here every registered planner
        # that publishes debug.reinit_msg is watched
        try:
            self.planning_store.revalidate()
            with self.planning_store.lock():
                msgs = {}
                for name in self.planning_store.planner_names:
                    comp = getattr(self.planning_store, name, None)
                    dbg = getattr(comp, "debug", None)
                    msg = getattr(dbg, "reinit_msg", None)
                    if msg is not None:
                        msgs[name] = str(msg)
            for name, msg in msgs.items():
                prev = self.last_reinit_msgs.get(name)
                if prev is not None and prev != msg and msg:
                    self._emit(time.time(), msg.split("#")[0])
                self.last_reinit_msgs[name] = msg
        except Exception:
            pass

    def events(self):
        self.update()
        return list(reversed(self._events))
