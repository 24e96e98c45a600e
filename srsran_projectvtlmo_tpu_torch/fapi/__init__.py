from .pdus import (
    SsbPdu, PdcchPdu, PdschPdu, PuschPdu, PucchPdu, PrachPdu,
    DlTtiRequest, UlTtiRequest, TxDataRequest,
    CrcIndication, RxDataIndication, UciIndication, RachIndication,
)
