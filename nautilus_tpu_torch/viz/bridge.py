"""Live ROS command bridge (port of nautilus_tpu/viz/bridge.py): the
reference's interactive input surface.

After the initial solve the reference subscribes to three topics and spins:
the configured ``hitl_lc_topic`` (default /hitl_slam_input,
HitlSlamInputMsg), /write_output and /vectorize_output (WriteMsg), routed
to a HITL step, the pose file and the line map.  An rviz operator with the
reference's HITL tool drives this bridge unchanged.

Subscriptions take ``rospy.AnyMsg`` and decode the raw buffers with
viz/ros_encode.py, so no generated message classes are needed.
``dispatch()`` is the transport-free core: tests feed wire-encoded messages
through the same handlers without a ROS master.  Only ``start`` and
``spin`` import rospy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from nautilus_tpu_torch.viz import ros_encode


class RosInputBridge:
    """Routes command-topic messages to a Solver."""

    def __init__(self, solver, config, verbose: bool = True,
                 on_write: Optional[Callable] = None,
                 on_vectorize: Optional[Callable] = None):
        self.solver = solver
        self.config = config
        self.verbose = verbose
        self._on_write = on_write
        self._on_vectorize = on_vectorize
        self.hitl_topic = str(config.get("hitl_lc_topic",
                                         "/hitl_slam_input"))
        self.handled = 0
        self._subs = []

    # -- transport-free core -------------------------------------------------

    def topics(self) -> Dict[str, Callable[[bytes], None]]:
        return {
            self.hitl_topic: self.handle_hitl,
            "/write_output": self.handle_write,
            "/vectorize_output": self.handle_vectorize,
        }

    def dispatch(self, topic: str, buff: bytes) -> None:
        """Deliver one wire-encoded message body to its handler."""
        handler = self.topics().get(topic)
        if handler is None:
            raise KeyError(f"bridge does not subscribe to {topic}")
        handler(buff)

    def handle_hitl(self, buff: bytes) -> None:
        from nautilus_tpu_torch.solve.hitl import (HitlSlamInputMsg,
                                                   hitl_callback)
        a0, a1, b0, b1 = ros_encode.decode_hitl_input(buff)
        msg = HitlSlamInputMsg.from_points(a0, a1, b0, b1)
        hitl_callback(self.solver, msg, verbose=self.verbose)
        self.handled += 1

    def handle_write(self, buff: bytes) -> None:
        # The value is validated and unused, as in the reference.
        ros_encode.decode_write_msg(buff)
        if self._on_write is not None:
            self._on_write()
        else:
            from nautilus_tpu_torch.io.poses import write_poses
            write_poses(self.solver.state, self.config.pose_output_file)
            if self.verbose:
                print(f"Wrote poses to {self.config.pose_output_file}")
        self.handled += 1

    def handle_vectorize(self, buff: bytes) -> None:
        ros_encode.decode_write_msg(buff)
        if self._on_vectorize is not None:
            self._on_vectorize()
        else:
            from nautilus_tpu_torch.io.vectorize import vectorize
            lines = vectorize(self.solver.state, self.config.map_output_file,
                              verbose=self.verbose)
            vis = getattr(self.solver, "visualizer", None)
            if vis is not None and hasattr(vis, "publish_debug_lines"):
                vis.publish_debug_lines(lines)
        self.handled += 1

    # -- rospy transport -----------------------------------------------------

    def start(self, node_name: str = "nautilus_tpu_torch") -> None:
        """Subscribe through rospy (ImportError without it)."""
        import rospy
        if rospy.core.get_node_uri() is None:
            rospy.init_node(node_name, anonymous=True, disable_signals=True)
        for topic, handler in self.topics().items():
            self._subs.append(rospy.Subscriber(
                topic, rospy.AnyMsg,
                (lambda h: lambda m: h(m._buff))(handler), queue_size=10))
        if self.verbose:
            print("Waiting for Loop Closure input")

    def spin(self) -> None:
        import rospy
        rospy.spin()

    def stop(self) -> None:
        for s in self._subs:
            s.unregister()
        self._subs.clear()
