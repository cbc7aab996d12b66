"""UAV telemetry state model + MAVLink-style simulator.

Parity target: the reference's ``pkg/uav/mavlink_simulator.go`` — the
UAVState tree (:11-106 — GPS/Attitude/Flight/Battery/Mission/Health),
initial state (:118-176), the 10 Hz update loop (:248-262), circular AUTO
flight path + attitude wobble (:272-297), battery discharge with
voltage/temperature coupling and time-remaining estimate (:311-329),
WARNING <20% / CRITICAL <10% transitions (:336-347), the bounded message
ring (:350-352), and the command set (Arm requires a 3D GPS fix, :224).
"""

from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import make_lock
from k8s_llm_monitor_tpu_torch.monitor.models import to_jsonable, utcnow

UPDATE_RATE_HZ = 10.0  # ref mavlink_simulator.go:172
CENTER_LAT = 39.9042
CENTER_LON = 116.4074


@dataclass
class GPSData:
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    relative_altitude: float = 0.0
    hdop: float = 0.0
    satellite_count: int = 0
    fix_type: int = 0  # 0=none, 2=2D, 3=3D
    ground_speed: float = 0.0
    course_over_ground: float = 0.0
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class AttitudeData:
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    roll_rate: float = 0.0
    pitch_rate: float = 0.0
    yaw_rate: float = 0.0
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class FlightData:
    mode: str = "STABILIZE"  # MANUAL STABILIZE LOITER AUTO RTL LAND
    armed: bool = False
    airspeed: float = 0.0
    ground_speed: float = 0.0
    vertical_speed: float = 0.0
    throttle_percent: float = 0.0
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class BatteryData:
    voltage: float = 0.0
    current: float = 0.0
    remaining_percent: float = 100.0
    remaining_capacity: float = 0.0  # mAh
    total_capacity: float = 0.0  # mAh
    temperature: float = 0.0  # °C
    cell_count: int = 0
    time_remaining: int = 0  # s
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class MissionData:
    current_waypoint: int = 0
    total_waypoints: int = 0
    mission_state: str = "IDLE"  # IDLE ACTIVE PAUSED COMPLETED
    distance_to_wp: float = 0.0
    eta_to_wp: int = 0
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class HealthData:
    system_status: str = "OK"  # OK WARNING CRITICAL ERROR
    sensors_health: dict[str, bool] = field(default_factory=dict)
    error_count: int = 0
    warning_count: int = 0
    messages: list[str] = field(default_factory=list)
    last_heartbeat: datetime = field(default_factory=utcnow)
    timestamp: datetime = field(default_factory=utcnow)


@dataclass
class UAVState:
    uav_id: str = ""
    node_name: str = ""
    system_time: datetime = field(default_factory=utcnow)
    gps: GPSData = field(default_factory=GPSData)
    attitude: AttitudeData = field(default_factory=AttitudeData)
    flight: FlightData = field(default_factory=FlightData)
    battery: BatteryData = field(default_factory=BatteryData)
    mission: MissionData = field(default_factory=MissionData)
    health: HealthData = field(default_factory=HealthData)

    def to_dict(self) -> dict[str, Any]:
        return to_jsonable(self)


MAX_HEALTH_MESSAGES = 10


class MAVLinkSimulator:
    """Simulated flight controller ticking at 10 Hz on a daemon thread."""

    def __init__(self, uav_id: str, node_name: str, seed: int | None = None) -> None:
        rng = random.Random(seed)
        self._rng = rng
        self._state = UAVState(
            uav_id=uav_id,
            node_name=node_name,
            gps=GPSData(
                latitude=CENTER_LAT + rng.random() * 0.01,
                longitude=CENTER_LON + rng.random() * 0.01,
                altitude=50.0,
                fix_type=3,
                satellite_count=12,
                hdop=1.0,
            ),
            battery=BatteryData(
                voltage=22.2,  # 6S pack
                current=0.5,  # idle draw
                remaining_percent=100.0,
                remaining_capacity=5000.0,
                total_capacity=5000.0,
                temperature=25.0,
                cell_count=6,
            ),
            health=HealthData(
                sensors_health={
                    "gps": True,
                    "compass": True,
                    "accelerometer": True,
                    "gyroscope": True,
                    "barometer": True,
                    "battery": True,
                }
            ),
        )
        self._lock = make_lock("uav.sim", reentrant=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._elapsed = 0.0
        self.update_period = 1.0 / UPDATE_RATE_HZ

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"uav-sim-{self._state.uav_id}", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _loop(self) -> None:
        while not self._stop.wait(self.update_period):
            self.tick(self.update_period)

    # -- state access ----------------------------------------------------------

    def get_state(self) -> dict[str, Any]:
        """JSON-shaped deep copy of the current state (thread-safe)."""
        with self._lock:
            return self._state.to_dict()

    # -- commands (ref :214-245, :358-388) --------------------------------------

    def set_flight_mode(self, mode: str) -> None:
        with self._lock:
            self._state.flight.mode = mode
            self._message(f"Flight mode changed to: {mode}")

    def arm(self) -> bool:
        with self._lock:
            if self._state.gps.fix_type < 3:
                return False  # needs a 3D fix
            self._state.flight.armed = True
            self._message("Armed")
            return True

    def disarm(self) -> None:
        with self._lock:
            self._state.flight.armed = False
            self._message("Disarmed")

    def take_off(self, altitude: float = 50.0) -> bool:
        with self._lock:
            if not self._state.flight.armed:
                return False
            self._state.flight.mode = "AUTO"
            self._state.mission.mission_state = "ACTIVE"
            self._message(f"Taking off to altitude: {altitude:.0f}m")
            return True

    def land(self) -> None:
        with self._lock:
            self._state.flight.mode = "LAND"
            self._message("Landing initiated")

    def return_to_launch(self) -> None:
        with self._lock:
            self._state.flight.mode = "RTL"
            self._message("Returning to launch")

    def _message(self, msg: str) -> None:
        msgs = self._state.health.messages
        msgs.append(msg)
        if len(msgs) > MAX_HEALTH_MESSAGES:
            del msgs[:-MAX_HEALTH_MESSAGES]

    # -- dynamics (ref :272-352) ------------------------------------------------

    def tick(self, dt: float | None = None) -> None:
        """Advance the simulation one step. Exposed for deterministic tests
        (the thread loop calls it at 10 Hz)."""
        dt = dt if dt is not None else self.update_period
        rng = self._rng
        with self._lock:
            self._elapsed += dt
            t = self._elapsed
            s = self._state
            now = utcnow()

            # GPS: circular flight path in armed AUTO mode
            if s.flight.armed and s.flight.mode == "AUTO":
                radius = 0.001  # ~100 m
                omega = 0.1  # rad/s
                s.gps.latitude = CENTER_LAT + radius * math.cos(omega * t)
                s.gps.longitude = CENTER_LON + radius * math.sin(omega * t)
                s.gps.relative_altitude = 50.0 + 10.0 * math.sin(0.05 * t)
                s.gps.ground_speed = 5.0 + rng.random() * 0.5
                s.gps.course_over_ground = (omega * t * 180.0 / math.pi) % 360.0
            s.gps.timestamp = now

            # attitude wobble while armed
            if s.flight.armed:
                s.attitude.roll = 5.0 * math.sin(0.5 * t) + rng.random() * 0.5
                s.attitude.pitch = 3.0 * math.cos(0.3 * t) + rng.random() * 0.3
                s.attitude.yaw = s.gps.course_over_ground % 360.0
                s.attitude.roll_rate = rng.random() * 2.0 - 1.0
                s.attitude.pitch_rate = rng.random() * 2.0 - 1.0
                s.attitude.yaw_rate = rng.random() * 5.0 - 2.5
            s.attitude.timestamp = now

            # flight data
            if s.flight.armed:
                s.flight.airspeed = s.gps.ground_speed + rng.random() * 0.5
                s.flight.ground_speed = s.gps.ground_speed
                s.flight.vertical_speed = math.cos(0.05 * t) * 2.0
                s.flight.throttle_percent = 50.0 + 20.0 * math.sin(0.1 * t)
            else:
                s.flight.throttle_percent = 0.0
                s.flight.vertical_speed = 0.0
            s.flight.timestamp = now

            # battery: ~0.1%/s discharge while armed, with voltage sag and
            # temperature rise coupled to depth of discharge
            if s.flight.armed:
                s.battery.remaining_percent = max(
                    0.0, s.battery.remaining_percent - 0.1 * dt
                )
                s.battery.remaining_capacity = (
                    s.battery.total_capacity * s.battery.remaining_percent / 100.0
                )
                s.battery.current = 10.0 + s.flight.throttle_percent * 0.2
                s.battery.voltage = 22.2 - (100.0 - s.battery.remaining_percent) * 0.04
                s.battery.temperature = (
                    25.0 + (100.0 - s.battery.remaining_percent) * 0.3
                )
                if s.battery.current > 0:
                    s.battery.time_remaining = int(
                        s.battery.remaining_capacity / s.battery.current * 3600 / 1000
                    )
            s.battery.timestamp = now

            # health transitions
            s.health.last_heartbeat = now
            s.health.timestamp = now
            if s.battery.remaining_percent < 10.0:
                if s.health.system_status != "CRITICAL":
                    s.health.system_status = "CRITICAL"
                    s.health.error_count += 1
                    self._message("Critical battery level - RTL recommended")
            elif s.battery.remaining_percent < 20.0 and s.health.system_status == "OK":
                s.health.system_status = "WARNING"
                s.health.warning_count += 1
                self._message("Low battery warning")

            s.system_time = now

    # -- test helpers -----------------------------------------------------------

    def set_battery_percent(self, pct: float) -> None:
        with self._lock:
            self._state.battery.remaining_percent = pct
            self._state.battery.remaining_capacity = (
                self._state.battery.total_capacity * pct / 100.0
            )
