"""Model -> standalone C++ if-else code generation (port of
lightgbm_tpu/codegen.py).

The analog of the reference's convert_model task
(reference: gbdt_model_text.cpp:182-233 ModelToIfElse /
SaveModelToIfElse, tree.cpp NumericalDecisionIfElse /
CategoricalDecisionIfElse) used by the codegen-equivalence CI test
(.travis/test.sh:58-65): emits one nested-if function per tree plus an
extern "C" PredictRaw that sums them, compilable with g++ into a shared
library whose outputs must match Booster.predict(raw_score=True).
"""
from __future__ import annotations

from typing import List

from .tree import Tree, K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK


def _tree_to_ifelse(tree: Tree, name: str) -> str:
    lines: List[str] = []
    lines.append(f"static double {name}(const double* arr) {{")
    cat_arrays: List[str] = []

    def emit(node: int, indent: int):
        pad = "  " * indent
        if node < 0:
            leaf = -node - 1
            lines.append(f"{pad}return {float(tree.leaf_value[leaf])!r};")
            return
        f = int(tree.split_feature[node])
        dt = int(tree.decision_type[node])
        if dt & K_CATEGORICAL_MASK:
            ci = int(tree.threshold[node])
            lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            words = tree.cat_threshold[lo:hi]
            arr_name = f"{name}_cat{ci}"
            cat_arrays.append(
                f"static const unsigned int {arr_name}[] = "
                "{" + ", ".join(f"{w}u" for w in words) + "};")
            cond = (f"!std::isnan(arr[{f}]) && (int)arr[{f}] >= 0 && "
                    f"FindInBitset({arr_name}, {len(words)}, "
                    f"(int)arr[{f}])")
            lines.append(f"{pad}if ({cond}) {{")
            emit(int(tree.left_child[node]), indent + 1)
            lines.append(f"{pad}}} else {{")
            emit(int(tree.right_child[node]), indent + 1)
            lines.append(f"{pad}}}")
            return
        mtype = (dt >> 2) & 3
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        thr = repr(float(tree.threshold[node]))
        v = f"arr[{f}]"
        if mtype == 2:   # NaN missing
            cond = (f"std::isnan({v}) ? {str(default_left).lower()} : "
                    f"({v} <= {thr})")
        elif mtype == 1:  # zero missing
            cond = (f"(IsZero(std::isnan({v}) ? 0.0 : {v})) ? "
                    f"{str(default_left).lower()} : "
                    f"((std::isnan({v}) ? 0.0 : {v}) <= {thr})")
        else:
            cond = f"(std::isnan({v}) ? 0.0 : {v}) <= {thr}"
        lines.append(f"{pad}if ({cond}) {{")
        emit(int(tree.left_child[node]), indent + 1)
        lines.append(f"{pad}}} else {{")
        emit(int(tree.right_child[node]), indent + 1)
        lines.append(f"{pad}}}")

    if tree.num_leaves <= 1:
        lines.append(f"  return {float(tree.leaf_value[0])!r};")
    else:
        emit(0, 1)
    lines.append("}")
    return "\n".join(cat_arrays + lines)


def model_to_ifelse_cpp(booster) -> str:
    """Emit the full translation unit for a trained booster."""
    k = max(booster.num_tree_per_iteration, 1)
    parts = [
        "// generated by lightgbm_tpu_torch convert_model "
        "(if-else prediction code)",
        "#include <cmath>",
        "",
        "static inline bool IsZero(double v) "
        "{ return v > -1e-35 && v <= 1e-35; }",
        "static inline bool FindInBitset(const unsigned int* bits, int n, "
        "int pos) {",
        "  int i1 = pos / 32;",
        "  if (i1 < 0 || i1 >= n) return false;",
        "  return (bits[i1] >> (pos % 32)) & 1;",
        "}",
        "",
    ]
    names = []
    if getattr(booster, 'gbdt', None) is not None:
        booster._sync_models()
    for i, tree in enumerate(booster.models):
        nm = f"PredictTree{i}"
        names.append(nm)
        parts.append(_tree_to_ifelse(tree, nm))
        parts.append("")
    parts.append(f'extern "C" void PredictRaw(const double* features, '
                 "double* output) {")
    for cls in range(k):
        sum_expr = " + ".join(f"{nm}(features)"
                              for i, nm in enumerate(names)
                              if i % k == cls) or "0.0"
        parts.append(f"  output[{cls}] = {sum_expr};")
    parts.append("}")
    parts.append(f'extern "C" int GetNumClasses() {{ return {k}; }}')
    parts.append("")
    return "\n".join(parts)
