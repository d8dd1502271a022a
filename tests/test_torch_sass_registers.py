"""The SASS register reader of scripts/sass_registers.py on a listing in
`cuobjdump -sass`'s form (the disassembler runs only beside the card)."""

from korean_f5_tts_tpu_torch.scripts.sass_registers import registers

LISTING = """
        Function : _ZN2f5kernel_aE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.MOV.U32 R219, RZ, RZ, UR4 ;
        /*0020*/                   STS.128 [R12+0x10], R8 ;
        Function : _ZN2f5kernel_bE
        /*0000*/                   FFMA R3, R2, R2, RZ ;
        /*0010*/                   EXIT ;
        Function : _ZN2f5kernel_cE
        /*0000*/                   EXIT ;
"""


def test_registers_are_the_highest_index_plus_one_per_kernel():
    # RZ (the zero register) and the uniform registers URn are not counted
    assert registers(LISTING) == {"_ZN2f5kernel_aE": 220, "_ZN2f5kernel_bE": 4,
                                  "_ZN2f5kernel_cE": 0}
