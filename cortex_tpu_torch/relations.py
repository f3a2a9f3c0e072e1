"""Well-known relations (reference: crates/cortex-core/src/relations.rs:6-62)."""

INFORMED_BY = "informed_by"
LED_TO = "led_to"
APPLIES_TO = "applies_to"
CONTRADICTS = "contradicts"
SUPERSEDES = "supersedes"
DEPENDS_ON = "depends_on"
RELATED_TO = "related_to"
INSTANCE_OF = "instance_of"
USES = "uses"
BRANCHED_FROM = "branched_from"
INHERITS_FROM = "inherits_from"
USED_BY = "used_by"
PERFORMED = "performed"
DEPLOYED = "deployed"
OBSERVED_WITH = "observed_with"
OBSERVED_BY = "observed_by"
ROLLED_BACK = "rolled_back"
ROLLED_BACK_TO = "rolled_back_to"

ALL = [
    INFORMED_BY, LED_TO, APPLIES_TO, CONTRADICTS, SUPERSEDES, DEPENDS_ON,
    RELATED_TO, INSTANCE_OF, USES, BRANCHED_FROM, INHERITS_FROM, USED_BY,
    PERFORMED, DEPLOYED, OBSERVED_WITH, OBSERVED_BY, ROLLED_BACK, ROLLED_BACK_TO,
]
