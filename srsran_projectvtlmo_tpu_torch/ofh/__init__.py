"""O-RAN 7.2 fronthaul (Open Fronthaul) wire protocols.

A copy of `srsran_projectvtlmo_tpu.ofh`, held equal to it by
tests/test_torch_host_copies.py.  The split of the reference's lib/ofh: IQ
(de)compression and bit packing run as batched torch ops on the caller's
device (ops/ofh_compression), while the byte-level eCPRI and U-plane message
framing here is host-side — it sits at
the NIC boundary, exactly where the reference keeps it on CPU too.

reference: lib/ofh/ecpri/*, lib/ofh/serdes/*, lib/ofh/receiver/*.
"""

from .ecpri import (  # noqa: F401
    EcpriIqPacket,
    EcpriRtControlPacket,
    build_iq_data_packet,
    build_rt_control_packet,
    decode_packet,
)
from .uplane import (  # noqa: F401
    UplaneMessageParams,
    UplaneDecodeResult,
    build_uplane_message,
    decode_uplane_message,
)
from .reception import SequenceIdChecker, RxWindowChecker  # noqa: F401
