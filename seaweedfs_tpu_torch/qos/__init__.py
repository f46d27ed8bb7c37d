"""QoS admission-control plane (admission + burn-driven actuation).

The first subsystem that ACTS on the telemetry stack: per-tenant token
buckets and priority classes at every gateway's front door
(qos/admission.py), tightened and relaxed by the SLO-burn feedback loop
(qos/actuator.py). See each module's docstring for the design."""

from seaweedfs_tpu_torch.qos.admission import (  # noqa: F401
    PRIORITY_CLASSES,
    QOS_FAMILIES,
    SHED_REASONS,
    AdmissionController,
    Decision,
    TokenBucket,
    admit,
    classify,
    controller,
    enable,
    parse_limits_spec,
)
