"""Instructions a sample in the DCN kernel's main loop, from its SASS.

    python -m otpose_tpu_torch.tools.dcn_sass

Builds ``csrc/deform_conv.cu`` (if it is not built yet), disassembles it with
``cuobjdump -sass`` and, for the flagship instantiations (exact mode, 16-byte
copies, O padded to 20, x planes staged; bf16 and f32), counts the
instructions of the main loop (the longest backward branch: one stage, that
is 9 taps x 2 pixels a thread, with the next stage's copies) by opcode, per
sample.  Needs the CUDA toolkit; no device is used.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess

# the flagship instantiation's mangled name: exact mode, 16-byte copies,
# NQ = 5 (O = 17 padded to 20), x planes staged
FLAGSHIP = re.compile(r"deform_staged_kernelI(13__nv_bfloat16|f)Li0ELb1ELi5ELb1E")
SAMPLES_A_PASS = 9 * 2


def loop_mix(sass: str, dtype_tag: str) -> tuple:
    """(instructions a sample, {opcode: count a sample}) of the flagship
    instantiation's main loop whose mangled name holds ``dtype_tag``."""
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        if not (FLAGSHIP.search(name) and dtype_tag in name):
            continue
        ops = [(int(a, 16), t.strip())
               for a, t in re.findall(r"/\*([0-9a-f]{4,6})\*/\s+([^;/]*);", func)]
        back = [(a, int(m.group(1), 16)) for a, t in ops
                for m in [re.search(r"BRA (0x[0-9a-f]+)", t)] if m and int(m.group(1), 16) < a]
        end, start = max(back, key=lambda ab: ab[0] - ab[1])
        body = [t for a, t in ops if start <= a <= end]
        mix = collections.Counter((t.split()[1] if t.startswith("@") else t.split()[0])
                                  .split(".")[0] for t in body)
        return (len(body) / SAMPLES_A_PASS,
                {k: v / SAMPLES_A_PASS for k, v in mix.most_common(12)})
    raise RuntimeError(f"dcn_sass: no flagship {dtype_tag} kernel in the SASS")


def main() -> None:
    from otpose_tpu_torch.ops.cuda import build

    build.build_all(("deform_conv",))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._target("deform_conv"))],
                          capture_output=True, text=True, check=True).stdout
    for tag, label in (("kernelI13", "bf16"), ("kernelIf", "f32")):
        per_sample, mix = loop_mix(sass, tag)
        print(f"main loop, {label}: {per_sample:.1f} instructions a sample; "
              + ", ".join(f"{k} {v:.1f}" for k, v in mix.items()), flush=True)


if __name__ == "__main__":
    main()
