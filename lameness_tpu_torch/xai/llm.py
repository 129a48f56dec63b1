"""Evidence-grounded LLM explanation service (port of
``lameness_tpu/xai/llm.py``, copied; Ollama is posted to with
``urllib.request``, since the card's machine has no httpx).

Behavioral rebuild of ``services/llm-service/app/main.py:21-524``: a
strict evidence-only system prompt, the structured explanation template
(pipeline summary / quality / gait / SHAP / human consensus / agreement
sections), and provider fallback OpenAI → Ollama → deterministic local
template.  The local fallback produces the same four-section output format
from the data alone, so explanations exist even with zero egress.

NOTE: ``SYSTEM_PROMPT`` below reproduces the reference's prompt prose
verbatim (``services/llm-service/app/main.py:37-61``) BY DESIGN — it is
the output contract: downstream consumers (frontend explanation panes,
the explanation parser, human raters) depend on the exact section
headers and rule semantics this prose induces, so paraphrasing it would
change model behavior against the same providers. It is a prose
constant, not code.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

SYSTEM_PROMPT = """You are a veterinary AI assistant explaining lameness predictions for dairy cows.

STRICT RULES:
1. ONLY reference the data provided in the user message
2. NEVER invent or assume information not in the input
3. If evidence is missing or conflicting, explicitly say so
4. Keep explanations clear and actionable for farm staff
5. Use simple language, avoid jargon

OUTPUT FORMAT (use exact headers):
## Executive Summary
(2-3 sentences: Main conclusion with confidence level)

## Key Evidence
(Bullet points of supporting data from pipelines)

## Uncertainties
(Any missing data or model disagreements)

## Recommended Action
(Clear next step for farm staff)"""


def _fmt_pipeline_summary(contribs: Dict[str, Any]) -> str:
    if not contribs:
        return "- No pipeline predictions available"
    lines = []
    for name, c in contribs.items():
        lines.append(f"- {name}: {c.get('probability', 0.5):.1%} "
                     f"(uncertainty {c.get('uncertainty', 0.5):.2f}, "
                     f"weight {c.get('weight', 0.1):.2f})")
    return "\n".join(lines)


def _fmt_gait(tleap: Dict[str, Any]) -> str:
    if not tleap:
        return "- No gait features available"
    keys = ("back_arch_score", "head_bob_score", "front_leg_asymmetry",
            "rear_leg_asymmetry", "lameness_score")
    lines = [f"- {k}: {tleap[k]:.3f}" for k in keys if k in tleap]
    return "\n".join(lines) if lines else "- No gait features available"


def _fmt_shap(shap: Dict[str, Any]) -> str:
    top = shap.get("top_features") or []
    if not top:
        return "- SHAP explanation not available"
    return "\n".join(
        f"- {t['feature']}: {t['shap_value']:+.4f} "
        f"(value {t['feature_value']:.3f})" for t in top)


def _fmt_human(human: Dict[str, Any]) -> str:
    if not human:
        return "- No human consensus available"
    return (f"- probability {human.get('probability', 0.5):.1%} from "
            f"{human.get('num_raters', 0)} raters")


def build_prompt(fusion_result: Dict[str, Any],
                 shap_data: Optional[Dict[str, Any]] = None,
                 quality_data: Optional[Dict[str, Any]] = None) -> str:
    """The structured template (llm:59-87,241-295)."""
    p = fusion_result.get("final_probability", 0.5)
    conf = fusion_result.get("confidence", 0.5)
    label = "Lame" if p > 0.5 else "Sound"
    conf_level = "High" if conf > 0.7 else "Medium" if conf > 0.4 else "Low"
    contribs = fusion_result.get("pipeline_contributions", {})
    quality_data = quality_data or {}
    agreement = fusion_result.get("model_agreement", 0.5)
    unanimous = fusion_result.get("unanimous", False)
    agreement_level = ("Unanimous" if unanimous else
                       "High" if agreement > 0.8 else
                       "Medium" if agreement > 0.5 else "Low")
    return f"""Generate an explanation for this lameness prediction:

## Final Decision
- Prediction: {label} ({p:.1%} probability)
- Confidence: {conf_level} ({conf:.1%})
- Decision Mode: {fusion_result.get('decision_mode', 'unknown')}

## Pipeline Predictions
{_fmt_pipeline_summary(contribs)}

## Quality Indicators
- Clip Quality: {quality_data.get('clip_quality', 'Unknown')}
- Pose Quality: {quality_data.get('pose_quality', 'Unknown')}
- Detection Confidence: {quality_data.get('detection_confidence', 'Unknown')}

## Gait Features (from T-LEAP)
{_fmt_gait(fusion_result.get('tleap_features', {}))}

## Top SHAP Features
{_fmt_shap(shap_data or {})}

## Human Consensus
{_fmt_human(contribs.get('human', {}))}

## Model Agreement
- Agreement Level: {agreement_level}
- Models in agreement: {len(contribs)} pipelines

Generate a clear explanation following the output format specified."""


def local_explanation(fusion_result: Dict[str, Any],
                      shap_data: Optional[Dict[str, Any]] = None) -> str:
    """Deterministic template explanation (zero-egress fallback) in the
    same four-section output format."""
    p = fusion_result.get("final_probability", 0.5)
    conf = fusion_result.get("confidence", 0.5)
    label = "lame" if p > 0.5 else "sound"
    conf_level = "high" if conf > 0.7 else "medium" if conf > 0.4 else "low"
    contribs = fusion_result.get("pipeline_contributions", {})
    mode = fusion_result.get("decision_mode", "unknown")
    tleap = fusion_result.get("tleap_features", {})

    evidence = []
    for name, c in contribs.items():
        verdict = "lame" if c.get("probability", 0.5) > 0.5 else "sound"
        evidence.append(f"- {name} predicts {verdict} "
                        f"({c.get('probability', 0.5):.1%})")
    for k, label_k in (("back_arch_score", "back-arch"),
                       ("head_bob_score", "head-bob"),
                       ("front_leg_asymmetry", "front-leg asymmetry"),
                       ("rear_leg_asymmetry", "rear-leg asymmetry")):
        if k in tleap:
            evidence.append(f"- gait {label_k}: {tleap[k]:.3f}")
    if shap_data and shap_data.get("top_features"):
        t = shap_data["top_features"][0]
        direction = "towards lame" if t["shap_value"] > 0 else "towards sound"
        evidence.append(f"- strongest tabular driver: {t['feature']} "
                        f"({t['shap_value']:+.4f}, {direction})")

    uncertainties = []
    if mode == "uncertain":
        uncertainties.append("- models disagree; the gate marked this video "
                             "uncertain")
    if "human" not in contribs:
        uncertainties.append("- no human consensus is available yet")
    if conf < 0.4:
        uncertainties.append(f"- overall confidence is low ({conf:.1%})")
    if not uncertainties:
        uncertainties.append("- none noted; inputs are consistent")

    action = fusion_result.get(
        "recommendation", "Continue routine observation.")
    return f"""## Executive Summary
The system predicts this cow is {label} with {p:.1%} probability at \
{conf_level} confidence (decision mode: {mode}).

## Key Evidence
{chr(10).join(evidence) if evidence else '- no pipeline evidence recorded'}

## Uncertainties
{chr(10).join(uncertainties)}

## Recommended Action
{action}"""


class LLMExplanationService:
    """Provider fallback OpenAI → Ollama → local template (llm:113-141)."""

    def __init__(self, dirs, openai_api_key: Optional[str] = None,
                 ollama_url: Optional[str] = None):
        self.dirs = dirs
        self.results_dir = dirs.results / "explanations"
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self.openai_api_key = openai_api_key
        self.ollama_url = ollama_url

    def _try_openai(self, prompt: str) -> Optional[str]:
        if not self.openai_api_key:
            return None
        try:
            import openai  # type: ignore
            client = openai.OpenAI(api_key=self.openai_api_key)
            r = client.chat.completions.create(
                model="gpt-4o-mini",
                messages=[{"role": "system", "content": SYSTEM_PROMPT},
                          {"role": "user", "content": prompt}],
                temperature=0.2)
            return r.choices[0].message.content
        except Exception:
            return None

    def _try_ollama(self, prompt: str) -> Optional[str]:
        if not self.ollama_url:
            return None
        try:
            import urllib.request
            body = json.dumps({"model": "llama3", "system": SYSTEM_PROMPT,
                               "prompt": prompt, "stream": False}).encode()
            req = urllib.request.Request(
                f"{self.ollama_url}/api/generate", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read()).get("response")
        except Exception:
            return None

    def explain(self, video_id: str, fusion_result: Dict[str, Any],
                shap_data: Optional[Dict[str, Any]] = None,
                quality_data: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        prompt = build_prompt(fusion_result, shap_data, quality_data)
        text = self._try_openai(prompt)
        provider = "openai"
        if text is None:
            text = self._try_ollama(prompt)
            provider = "ollama"
        if text is None:
            text = local_explanation(fusion_result, shap_data)
            provider = "local_template"
        result = {"video_id": video_id, "provider": provider,
                  "prompt": prompt, "explanation": text}
        from ..io import schemas
        schemas.write_result(     # atomic: the GET endpoint reads it live
            self.results_dir / f"{video_id}_explanation.json", result)
        return result

    def handle_analysis_complete(self, message: Dict[str, Any]):
        """``analysis.complete`` handler (llm:493-498)."""
        video_id = message.get("video_id")
        fusion = message.get("fusion_result", {})
        shap_file = self.dirs.results / "shap" / f"{video_id}_shap.json"
        shap_data = None
        if shap_file.exists():
            try:
                shap_data = json.load(open(shap_file))
            except Exception:
                pass
        return self.explain(video_id, fusion, shap_data)
